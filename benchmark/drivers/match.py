"""Exhaustive-matching traffic: a closed loop of one client running
``pipeline.match.match_exhaustive`` jobs over one scene, with verification
off and the descriptors taken from the device, as ``Pipeline.run`` hands
them over from the extractor.

Set-up makes the scene's signed uint8 descriptors on the card from the seed
(``inputs.arc_scene``), writes its camera, images and keypoints to a
database under the run's temporary directory, and warms a job up.  Each job
in the window first deletes the previous job's matches (inside the window),
then matches every pair and writes the ``matches`` table.  Once the program
is freed, the last job's rows, and those of one job drawn from the seed,
are read back from the database with SQLite and judged pair by pair against
the plain float64 reference.

Traffic parameters: ``views``, ``keypoints``, ``scene_points``,
``overlap_views``, ``noise`` (the range of an observation's noise norm),
``warmup_jobs``, and ``matching``, the matcher's deployment settings.
"""

from __future__ import annotations

import gc
import math
import shutil
import sqlite3
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.stats import window_rate
from benchmark.harness.trace import span
from benchmark.reference import match as ref_match

MAX_IMAGE_ID = 2**31 - 1  # COLMAP's pair_id = id1 * MAX_IMAGE_ID + id2
KEEP_AMONG = 8
KEPT_TABLE = "bench_kept_matches"
# The numbers this driver reads; a cell's limits file compares some of them.
NUMBERS = ("rows_differ", "row_violation")


class _SpannedWriter:
    """A bulk writer whose matches, commits and closes run inside the
    ``bench.db_write`` span; everything else passes through."""

    def __init__(self, writer):
        self._w = writer

    def __getattr__(self, name):
        return getattr(self._w, name)

    def add_matches(self, *a):
        with span("bench.db_write", True):
            return self._w.add_matches(*a)

    def commit(self):
        with span("bench.db_write", True):
            return self._w.commit()

    def close(self):
        with span("bench.db_write", True):
            return self._w.close()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 variant: str | None = None):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = device
        if variant not in (None, *ref_match.PRECISIONS):
            raise ValueError(f"variant {variant!r}")
        self.variant = variant
        self.attempted = self.failed = self.pairs = 0
        self.request_s: list[float] = []
        # The job whose rows are kept for the check besides the last one,
        # drawn from the seed among the first KEEP_AMONG of the window.
        self.keep_job = int(np.random.default_rng([self.seed, 13]).integers(KEEP_AMONG))
        self.errors: list[str] = []
        self.tmp: Path | None = None

    # ----------------------------------------------------------- set-up
    def setup(self, mark=lambda label: None) -> None:
        from vit_colmap_tpu_torch.database import ColmapDatabase
        from vit_colmap_tpu_torch.pipeline import match as pm
        from vit_colmap_tpu_torch.utils.config import MatchingConfig

        mark("import_program")
        t, m = self.traffic, self.traffic["matching"]
        dev = torch.device(self.device if self.device != "cuda" else "cuda:0")
        self.desc = inputs.arc_scene(t["views"], t["keypoints"], self.cfg["descriptor_dim"],
                                     t["scene_points"], t["overlap_views"], tuple(t["noise"]),
                                     self.seed, dev)
        mark("inputs")
        self.tmp = Path(tempfile.mkdtemp(prefix="bench_match_"))
        self.db_path = self.tmp / "scene.db"
        h, w = self.cfg["image_height"], self.cfg["image_width"]
        rng = np.random.default_rng([self.seed, 5])
        db = ColmapDatabase(self.db_path)
        try:
            cam = db.add_camera("SIMPLE_PINHOLE", w, h, [float(max(w, h)), w / 2, h / 2])
            self.names = [f"view_{v:03d}.png" for v in range(t["views"])]
            for name in self.names:
                iid = db.add_image(name, cam)
                xy = rng.uniform((0, 0), (w, h), size=(t["keypoints"], 2)).astype(np.float32)
                db.add_keypoints(iid, xy)
            db.commit()
        finally:
            db.close()
        con = sqlite3.connect(self.db_path)
        try:
            (self.schema,) = con.execute(
                "SELECT sql FROM sqlite_master WHERE type = 'table' AND name = 'matches'"
            ).fetchone()
        finally:
            con.close()
        self.cache = {n: (self.desc[v], t["keypoints"]) for v, n in enumerate(self.names)}
        self.mcfg = MatchingConfig(
            max_ratio=m["max_ratio"], max_distance=m["max_distance"],
            cross_check=m["cross_check"], max_num_matches=m["max_num_matches"],
            descriptor_encoding=self.cfg["descriptor_encoding"], pair_batch=m["pair_batch"],
            do_verification=False)
        self.pm = pm
        mark("database")
        if self.variant is not None:  # the control, put in the program's place
            self._matcher = pm.get_pair_matcher
            pm.get_pair_matcher = lambda *_a: ref_match.pair_matcher(self.variant)
        for _ in range(t["warmup_jobs"]):
            self._job(False)
        mark("warmup")

    def _job(self, traced: bool, keep_last: bool = False):
        """One job: clear the previous job's matches (or, with ``keep_last``,
        set them aside under KEPT_TABLE, as fast as a delete), then match."""
        with span("bench.reset", traced):
            con = sqlite3.connect(self.db_path)
            try:
                con.execute("PRAGMA journal_mode=MEMORY")  # as the program's connections
                con.execute("PRAGMA synchronous=OFF")
                if keep_last:
                    con.execute(f"ALTER TABLE matches RENAME TO {KEPT_TABLE}")
                    con.execute(self.schema)
                else:
                    con.execute("DELETE FROM matches")
                con.commit()
            finally:
                con.close()
        return self.pm.match_exhaustive(self.db_path, self.mcfg,
                                        device_descriptors=self.cache, device=self.device)

    # ----------------------------------------------------------- window
    def window(self, seconds: float, traced: bool) -> None:
        pm = self.pm
        if traced:
            opener = pm.open_bulk_writer

            def spanned(path):
                with span("bench.db_write", True):
                    return _SpannedWriter(opener(path))

            pm.open_bulk_writer = spanned
        self.t_start = now = time.perf_counter()
        deadline = self.t_start + seconds
        while now < deadline:
            t_in = now
            keep_last = self.attempted == self.keep_job + 1
            self.attempted += 1
            with span("bench.job", traced):
                try:
                    stats = self._job(traced, keep_last)
                except Exception:  # a failed request: counted, its trace kept
                    self.failed += 1
                    self.errors.append(traceback.format_exc())
                    stats = None
            now = time.perf_counter()
            self.request_s.append(now - t_in)
            if stats is not None:
                self.pairs += stats.num_pairs
        self.t_end = now
        if traced:
            pm.open_bulk_writer = opener

    def end_to_end(self) -> dict:
        return {"match_pairs_per_s": window_rate(self.pairs, self.t_start, self.t_end)}

    def counters(self) -> dict:
        v = self.traffic["views"]
        k = self.traffic["keypoints"]
        return {"jobs": self.attempted - self.failed, "pairs": self.pairs,
                "pairs_per_job": v * (v - 1) // 2, "keypoints": k,
                "dim": self.cfg["descriptor_dim"],
                "pair_batch": self.traffic["matching"]["pair_batch"]}

    def release(self) -> None:
        if self.variant is not None:
            self.pm.get_pair_matcher = self._matcher
        self.cache = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)

    # ------------------------------------------------------------ check
    def judge(self) -> dict:
        """The last job's rows, and those of the job drawn from the seed
        where the window reached the one after it, against the reference:
        each number's worst job."""
        tables = ["matches"] + ([KEPT_TABLE] if self.attempted > self.keep_job + 1 else [])
        worst: dict = {}
        for table in tables:
            got = judge_rows(read_matches(self.db_path, self.names, table), self.desc,
                             self.traffic["matching"])
            worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
        return worst


def read_matches(db_path: Path, names: list[str], table: str = "matches") -> dict:
    """{(view1, view2): (R, 2) int64 rows} of a table of matches, read with
    SQLite and numpy."""
    con = sqlite3.connect(db_path)
    try:
        ids = {iid: names.index(n) for iid, n in con.execute("SELECT image_id, name FROM images")}
        out = {}
        for pair_id, r, c, data in con.execute(f"SELECT pair_id, rows, cols, data FROM {table}"):
            i2 = pair_id % MAX_IMAGE_ID
            i1 = (pair_id - i2) // MAX_IMAGE_ID
            m = np.frombuffer(data, dtype=np.uint32).reshape(r, c).astype(np.int64) \
                if data is not None else np.zeros((0, 2), np.int64)
            out[(ids[i1], ids[i2])] = m
        return out
    finally:
        con.close()


def judge_rows(rows: dict, desc_u8: torch.Tensor, m: dict, chunk: int = 16) -> dict:
    """One job's rows of every pair against the float64 reference.

    ``rows_differ``: rows in one set and not the other, over the reference's
    rows.  ``row_violation``: the most by which a written row (a, b) breaks
    the reference's rule: the gap by which its similarity lies below the
    best of row a or of column b, or by which its angular distance passes
    the distance limit or the ratio limit against row a's second best."""
    views, k, _ = desc_u8.shape
    dev = desc_u8.device
    valid = torch.ones(views, k, dtype=torch.bool, device=dev)
    d = ref_match.decode(desc_u8, valid)
    pairs = [(i, j) for i in range(views) for j in range(i + 1, views)]
    differ = ref_total = 0
    violation = 0.0
    for s in range(0, len(pairs), chunk):
        ch = pairs[s:s + chunk]
        i1 = torch.tensor([p[0] for p in ch], device=dev)
        i2 = torch.tensor([p[1] for p in ch], device=dev)
        sim = ref_match.similarity(d[i1], d[i2], "f64")
        ref = ref_match.mutual(sim, valid[i1], valid[i2], m["max_ratio"], m["max_distance"])
        for b, p in enumerate(ch):
            want = torch.nonzero(ref["match"][b] >= 0)[:, 0]
            codes_ref = want * k + ref["match"][b][want]
            ref_total += len(want)
            r = torch.as_tensor(rows.get(p, np.zeros((0, 2), np.int64)), device=dev)
            if len(r) == 0:
                differ += len(want)
                continue
            if r.min() < 0 or r.max() >= k:
                return {"rows_differ": math.inf, "row_violation": math.inf}
            codes = r[:, 0] * k + r[:, 1]
            differ += int((~torch.isin(codes, codes_ref)).sum())
            differ += int((~torch.isin(codes_ref, codes)).sum())
            s_ab = sim[b, r[:, 0], r[:, 1]]
            dist = torch.arccos(s_ab.clamp(-1.0, 1.0))
            second = torch.arccos(ref["second"][b, r[:, 0]].clamp(-1.0, 1.0))
            worst = torch.stack([ref["best"][b, r[:, 0]] - s_ab, ref["col_best"][b, r[:, 1]] - s_ab,
                                 dist - m["max_distance"], dist - m["max_ratio"] * second])
            violation = max(violation, float(worst.max()))
        del sim, ref
    return {"rows_differ": differ / max(ref_total, 1), "row_violation": max(violation, 0.0)}
