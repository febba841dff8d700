// Batched COLMAP-database writer (host C++, bound with ctypes).
//
// The port's copy of the JAX package's native/db_writer.cc, with the same C
// ABI: the matching and verification drivers stream their blobs through it
// inside one transaction (vc_begin ... vc_commit) instead of one Python
// sqlite3 call per row.  Python binding: vit_colmap_tpu_torch/database/
// native.py; the schema, blobs and pair_id rule are those of
// vit_colmap_tpu_torch/database/colmap_db.py.
//
// Unlike the JAX package's copy, each INSERT is prepared once per open
// writer and reset after each row (Python's sqlite3 caches its statements
// the same way); the rows written are the same.
//
// Only the runtime libsqlite3.so.0 is needed: the subset of the (stable)
// SQLite C API used here is declared below, so no sqlite3.h is included.
//
// Built at first use by vit_colmap_tpu_torch/kernels/host_build.py.

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {
// --- minimal sqlite3 API surface (stable C ABI) ---
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
int sqlite3_open(const char*, sqlite3**);
int sqlite3_close(sqlite3*);
int sqlite3_exec(sqlite3*, const char*, int (*)(void*, int, char**, char**),
                 void*, char**);
int sqlite3_prepare_v2(sqlite3*, const char*, int, sqlite3_stmt**,
                       const char**);
int sqlite3_bind_int(sqlite3_stmt*, int, int);
int sqlite3_bind_int64(sqlite3_stmt*, int, int64_t);
int sqlite3_bind_text(sqlite3_stmt*, int, const char*, int, void (*)(void*));
int sqlite3_bind_blob(sqlite3_stmt*, int, const void*, int, void (*)(void*));
int sqlite3_bind_null(sqlite3_stmt*, int);
int sqlite3_step(sqlite3_stmt*);
int sqlite3_reset(sqlite3_stmt*);
int sqlite3_finalize(sqlite3_stmt*);
int64_t sqlite3_last_insert_rowid(sqlite3*);
const char* sqlite3_errmsg(sqlite3*);
#define SQLITE_OK 0
#define SQLITE_ROW 100
#define SQLITE_DONE 101
#define SQLITE_TRANSIENT ((void (*)(void*))(-1))
}

namespace {

constexpr int64_t kMaxImageId = 2147483647LL;

const char* kSchema = R"sql(
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model     INTEGER NOT NULL,
    width     INTEGER NOT NULL,
    height    INTEGER NOT NULL,
    params    BLOB,
    prior_focal_length INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS images (
    image_id  INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name      TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id)
);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE
);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE
);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB
);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB
);
)sql";

// The INSERTs, prepared at their first use by an open writer.
enum Stmt { kCamera, kImage, kKeypoints, kDescriptors, kMatches, kGeometry,
            kNumStmts };
const char* kInsert[kNumStmts] = {
    "INSERT INTO cameras VALUES (NULL, ?, ?, ?, ?, ?)",
    "INSERT INTO images VALUES "
    "(NULL, ?, ?, NULL, NULL, NULL, NULL, NULL, NULL, NULL)",
    "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
    "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
    "INSERT OR REPLACE INTO matches VALUES (?, ?, 2, ?)",
    "INSERT OR REPLACE INTO two_view_geometries VALUES "
    "(?, ?, 2, ?, ?, ?, ?, ?, ?, ?)",
};

struct Writer {
  sqlite3* db = nullptr;
  sqlite3_stmt* stmts[kNumStmts] = {};
  std::string last_error;
};

bool exec(Writer* w, const char* sql) {
  char* err = nullptr;
  if (sqlite3_exec(w->db, sql, nullptr, nullptr, &err) != SQLITE_OK) {
    w->last_error = err ? err : "unknown sqlite error";
    return false;
  }
  return true;
}

// The cached statement `which`, prepared on first use; nullptr (with
// last_error set) when it does not prepare.
sqlite3_stmt* statement(Writer* w, Stmt which) {
  if (!w->stmts[which] &&
      sqlite3_prepare_v2(w->db, kInsert[which], -1, &w->stmts[which],
                         nullptr) != SQLITE_OK) {
    w->last_error = sqlite3_errmsg(w->db);
    w->stmts[which] = nullptr;
  }
  return w->stmts[which];
}

// Runs a bound statement and resets it for the next row.
bool step(Writer* w, sqlite3_stmt* st) {
  int rc = sqlite3_step(st);
  if (rc != SQLITE_DONE) w->last_error = sqlite3_errmsg(w->db);
  sqlite3_reset(st);
  return rc == SQLITE_DONE;
}

int64_t pair_id(int64_t id1, int64_t id2) {
  if (id1 > id2) { int64_t t = id1; id1 = id2; id2 = t; }
  return id1 * kMaxImageId + id2;
}

}  // namespace

extern "C" {

void* vc_open(const char* path) {
  Writer* w = new Writer();
  if (sqlite3_open(path, &w->db) != SQLITE_OK) {
    delete w;
    return nullptr;
  }
  exec(w, "PRAGMA journal_mode=MEMORY");
  exec(w, "PRAGMA synchronous=OFF");
  if (!exec(w, kSchema)) {
    sqlite3_close(w->db);
    delete w;
    return nullptr;
  }
  return w;
}

void vc_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return;
  for (sqlite3_stmt* st : w->stmts) sqlite3_finalize(st);
  sqlite3_close(w->db);
  delete w;
}

const char* vc_last_error(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  return w ? w->last_error.c_str() : "null handle";
}

int vc_begin(void* handle) {
  return exec(static_cast<Writer*>(handle), "BEGIN") ? 0 : -1;
}

int vc_commit(void* handle) {
  return exec(static_cast<Writer*>(handle), "COMMIT") ? 0 : -1;
}

int64_t vc_add_camera(void* handle, int model, int width, int height,
                      const double* params, int num_params,
                      int prior_focal_length) {
  Writer* w = static_cast<Writer*>(handle);
  sqlite3_stmt* st = statement(w, kCamera);
  if (!st) return -1;
  sqlite3_bind_int(st, 1, model);
  sqlite3_bind_int(st, 2, width);
  sqlite3_bind_int(st, 3, height);
  sqlite3_bind_blob(st, 4, params, num_params * 8, SQLITE_TRANSIENT);
  sqlite3_bind_int(st, 5, prior_focal_length);
  return step(w, st) ? sqlite3_last_insert_rowid(w->db) : -1;
}

int64_t vc_add_image(void* handle, const char* name, int64_t camera_id) {
  Writer* w = static_cast<Writer*>(handle);
  sqlite3_stmt* st = statement(w, kImage);
  if (!st) return -1;
  sqlite3_bind_text(st, 1, name, -1, SQLITE_TRANSIENT);
  sqlite3_bind_int64(st, 2, camera_id);
  return step(w, st) ? sqlite3_last_insert_rowid(w->db) : -1;
}

static int write_feature_blob(Writer* w, Stmt which, int64_t image_id,
                              int rows, int cols, const void* data,
                              int elem_size) {
  sqlite3_stmt* st = statement(w, which);
  if (!st) return -1;
  sqlite3_bind_int64(st, 1, image_id);
  sqlite3_bind_int(st, 2, rows);
  sqlite3_bind_int(st, 3, cols);
  sqlite3_bind_blob(st, 4, data, rows * cols * elem_size, SQLITE_TRANSIENT);
  return step(w, st) ? 0 : -1;
}

int vc_write_keypoints(void* handle, int64_t image_id, int rows, int cols,
                       const float* data) {
  return write_feature_blob(static_cast<Writer*>(handle), kKeypoints,
                            image_id, rows, cols, data, 4);
}

int vc_write_descriptors(void* handle, int64_t image_id, int rows, int cols,
                         const uint8_t* data) {
  return write_feature_blob(static_cast<Writer*>(handle), kDescriptors,
                            image_id, rows, cols, data, 1);
}

// pairs: uint32 (rows, 2), given in (id1, id2) keypoint-index order; swapped
// in-place into canonical (min_id, max_id) column order when id1 > id2.
int vc_write_matches(void* handle, int64_t id1, int64_t id2, int rows,
                     const uint32_t* pairs) {
  Writer* w = static_cast<Writer*>(handle);
  std::string swapped;
  const void* data = pairs;
  if (id1 > id2 && rows > 0) {
    swapped.resize(static_cast<size_t>(rows) * 8);
    uint32_t* out = reinterpret_cast<uint32_t*>(&swapped[0]);
    for (int r = 0; r < rows; ++r) {
      out[2 * r] = pairs[2 * r + 1];
      out[2 * r + 1] = pairs[2 * r];
    }
    data = out;
  }
  sqlite3_stmt* st = statement(w, kMatches);
  if (!st) return -1;
  sqlite3_bind_int64(st, 1, pair_id(id1, id2));
  sqlite3_bind_int(st, 2, rows);
  sqlite3_bind_blob(st, 3, data, rows * 8, SQLITE_TRANSIENT);
  return step(w, st) ? 0 : -1;
}

int vc_write_two_view_geometry(void* handle, int64_t id1, int64_t id2,
                               int rows, const uint32_t* inliers, int config,
                               const double* F, const double* E,
                               const double* H, const double* qvec,
                               const double* tvec) {
  Writer* w = static_cast<Writer*>(handle);
  std::string swapped;
  const void* data = inliers;
  if (id1 > id2 && rows > 0) {
    swapped.resize(static_cast<size_t>(rows) * 8);
    uint32_t* out = reinterpret_cast<uint32_t*>(&swapped[0]);
    for (int r = 0; r < rows; ++r) {
      out[2 * r] = inliers[2 * r + 1];
      out[2 * r + 1] = inliers[2 * r];
    }
    data = out;
  }
  sqlite3_stmt* st = statement(w, kGeometry);
  if (!st) return -1;
  sqlite3_bind_int64(st, 1, pair_id(id1, id2));
  sqlite3_bind_int(st, 2, rows);
  sqlite3_bind_blob(st, 3, data, rows * 8, SQLITE_TRANSIENT);
  sqlite3_bind_int(st, 4, config);
  sqlite3_bind_blob(st, 5, F, 72, SQLITE_TRANSIENT);
  sqlite3_bind_blob(st, 6, E, 72, SQLITE_TRANSIENT);
  sqlite3_bind_blob(st, 7, H, 72, SQLITE_TRANSIENT);
  sqlite3_bind_blob(st, 8, qvec, 32, SQLITE_TRANSIENT);
  sqlite3_bind_blob(st, 9, tvec, 24, SQLITE_TRANSIENT);
  return step(w, st) ? 0 : -1;
}

}  // extern "C"
