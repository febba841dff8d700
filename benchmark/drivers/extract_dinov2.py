"""Extraction traffic on a DINOv2 backbone with registers and either MLP
form (``dinov2_vitg14_reg``): the ``extract`` driver's closed loop,
counters and comparison, judged against ``reference/dinov2.py``.

Set-up, beyond the ``extract`` driver's: once the extractor is built, and
before the seed's weights are drawn, it raises unless the model is at the
configuration's widths (each block's MLP weights, the register tokens), so
a program not at the published widths fails before any timing.  Once the
seed's weights are loaded it redraws the register tokens at std 0.5, like
the cls token (``harness/inputs.py`` draws unnamed parameters at 0.02), so
that a misplaced register moves the output past the limits.

Traffic parameters: those of the ``extract`` driver.
"""

from __future__ import annotations

import torch

from benchmark.drivers import extract
from benchmark.harness import inputs
from benchmark.reference import dinov2 as ref_dinov2
from benchmark.reference import features as ref_features

NUMBERS = extract.NUMBERS
REGISTER_STD = 0.5
REGISTER_STREAM = 5  # the seed's stream of the register tokens (inputs.generator)


def expected_shapes(cfg: dict) -> dict:
    """Shapes the configuration fixes: the register tokens, and each
    block's MLP weights (``w12``, ``w3`` for SwiGLU; ``fc1``, ``fc2`` for
    GELU), one block past the last absent."""
    d, h, depth = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    swiglu = cfg["mlp"] == "swiglu"
    first, second = ("w12", "w3") if swiglu else ("fc1", "fc2")
    want = {"register_tokens": (1, cfg["num_register_tokens"], d),
            f"blocks.{depth}.norm1.weight": None}
    for i in range(depth):
        want[f"blocks.{i}.mlp.{first}.weight"] = (2 * h if swiglu else h, d)
        want[f"blocks.{i}.mlp.{second}.weight"] = (d, h)
    return want


def check_widths(shapes: dict, cfg: dict) -> None:
    """Raise unless the state dict's ``shapes`` (key -> shape) are those of
    ``expected_shapes``."""
    bad = {k: (shapes.get(k), v) for k, v in expected_shapes(cfg).items()
           if shapes.get(k) != v}
    if bad:
        first = dict(list(bad.items())[:4])
        raise ValueError(f"{cfg['backbone']} is not at the configuration's widths "
                         f"({len(bad)} keys; key: (built, expected)): {first}")


class Driver(extract.Driver):
    def setup(self, mark=lambda label: None) -> None:
        def marked(label: str) -> None:
            if label == "extractor":
                check_widths({k: tuple(v.shape) for k, v in self.ext.model.state_dict().items()},
                             self.cfg)
            elif label == "weights":
                self._redraw_registers()
            mark(label)

        super().setup(marked)

    def _redraw_registers(self) -> None:
        """The seed's register tokens at std REGISTER_STD, in the weights the
        reference reads and in the program's model."""
        w = self.weights["register_tokens"]
        g = inputs.generator(self.seed, w.device, REGISTER_STREAM)
        w.normal_(0.0, REGISTER_STD, generator=g)
        with torch.no_grad():
            self.ext.model.register_tokens.copy_(w)

    def judge(self) -> dict:
        """The kept batches against ``reference/dinov2.py`` on their pool
        images: each number's worst image."""
        c = self.cfg
        dev = self.weights["pos_embed"].device
        comps, mean = self.pca
        refs: dict[int, list] = {}
        worst = dict.fromkeys(NUMBERS, 0.0 if self.kept else float("inf"))
        for k, out in self.kept:
            if k not in refs:
                refs[k] = []
                for img in self.batches[k]:
                    fmap = ref_dinov2.features(torch.from_numpy(img).to(dev), self.weights, c)
                    refs[k].append((fmap, *ref_features.keypoints(fmap, c)))
            xy, _scores, valid, desc = out[:4]
            for j, (fmap, rxy, rvalid, rcell) in enumerate(refs[k]):
                got = extract.compare(xy[j], valid[j], desc[j], fmap, rxy, rvalid, rcell,
                                      comps, mean)
                for name, v in got.items():
                    worst[name] = max(worst[name], v)
        return worst
