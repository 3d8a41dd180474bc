/* innr_tpu host-side native runtime.
 *
 * The device does the scoring; this library is the native half of the
 * *runtime around it*: data-loader encoders (bit packing, ternary planes,
 * u8 quantization) that prepare corpora for device upload without a JAX
 * round-trip, a streaming TopK tracker for host-side candidate merging
 * (the counterpart of reference src/topk.rs, with identical total_cmp
 * semantics), and packed-word Hamming for host-side verification.
 *
 * Plain C99 + OpenMP-free (deterministic, embeddable); exposed through
 * ctypes (innr_tpu/_native.py) with pure-Python fallbacks, so the wheel
 * works without a compiler and accelerates when one is present.
 *
 * Build: scripts/build_native.sh (cc -O3 -shared -fPIC).
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

/* ---------------------------------------------------------------- TopK --
 * f32 total-order key: bits ^ (sign ? 0x7FFFFFFF : 0). Matches Rust
 * f32::total_cmp (NaN sorts greatest) and utils/order.py exactly.
 */
static inline int32_t total_key(float f) {
  int32_t bits;
  memcpy(&bits, &f, sizeof bits);
  return bits ^ (int32_t)(((uint32_t)(bits >> 31)) >> 1);
}

/* Running k-smallest tracker over a stream of (id, distance) candidates.
 *
 * buf_d/buf_i hold up to k entries sorted descending by distance key
 * (worst at index 0 — O(1) threshold, reference src/topk.rs design).
 * *count is the current fill. Processes n candidates; the common-case
 * reject is a single integer compare.
 */
void innr_topk_insert_batch(const float *dists, const uint32_t *ids, int64_t n,
                            int32_t k, float *buf_d, uint32_t *buf_i,
                            int32_t *count) {
  int32_t c = *count;
  int32_t thr_key = (c < k) ? 0x7FFFFFFF : total_key(buf_d[0]);
  for (int64_t i = 0; i < n; ++i) {
    const float d = dists[i];
    const int32_t key = total_key(d);
    if (c >= k && key >= thr_key) continue; /* reject fast path */

    /* Find insert position in the descending buffer: leftmost j with
     * key(buf[j]) <= key — equal keys push toward higher indices. */
    int32_t lo = 0, hi = c;
    if (c >= k) { /* evict worst (index 0) by shifting left */
      memmove(buf_d, buf_d + 1, (size_t)(k - 1) * sizeof(float));
      memmove(buf_i, buf_i + 1, (size_t)(k - 1) * sizeof(uint32_t));
      c = k - 1;
      hi = c;
    }
    while (lo < hi) {
      int32_t mid = (lo + hi) / 2;
      if (total_key(buf_d[mid]) > key) lo = mid + 1;
      else hi = mid;
    }
    memmove(buf_d + lo + 1, buf_d + lo, (size_t)(c - lo) * sizeof(float));
    memmove(buf_i + lo + 1, buf_i + lo, (size_t)(c - lo) * sizeof(uint32_t));
    buf_d[lo] = d;
    buf_i[lo] = ids[i];
    ++c;
    if (c >= k) thr_key = total_key(buf_d[0]);
  }
  *count = c;
}

/* ------------------------------------------------------------- encoders --
 * Data-loader fast paths: encode f32 rows into device-upload layouts.
 */

/* Binary: bit i%32 of word i/32 set iff v[i] > threshold (strict). */
void innr_pack_binary(const float *v, int64_t n, float threshold,
                      uint32_t *out /* ceil(n/32) zeroed words */) {
  int64_t words = (n + 31) / 32;
  memset(out, 0, (size_t)words * sizeof(uint32_t));
  for (int64_t i = 0; i < n; ++i)
    if (v[i] > threshold) out[i >> 5] |= (uint32_t)1u << (i & 31);
}

/* Ternary bitplanes: pos bit iff v > t, neg bit iff v < -t. */
void innr_pack_ternary(const float *v, int64_t n, float threshold,
                       uint32_t *pos, uint32_t *neg) {
  int64_t words = (n + 31) / 32;
  memset(pos, 0, (size_t)words * sizeof(uint32_t));
  memset(neg, 0, (size_t)words * sizeof(uint32_t));
  for (int64_t i = 0; i < n; ++i) {
    if (v[i] > threshold) pos[i >> 5] |= (uint32_t)1u << (i & 31);
    else if (v[i] < -threshold) neg[i >> 5] |= (uint32_t)1u << (i & 31);
  }
}

/* Affine u8 quantization: round+clamp((v - offset) * 255 / alpha). */
void innr_quantize_u8(const float *v, int64_t n, float alpha, float offset,
                      uint8_t *out) {
  const float inv = 255.0f / alpha;
  for (int64_t i = 0; i < n; ++i) {
    float x = (v[i] - offset) * inv;
    x = x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
    /* round half away from zero like Rust f32::round / np.round-ish;
     * x >= 0 here so +0.5 truncation is round-half-up. */
    out[i] = (uint8_t)(x + 0.5f);
  }
}

/* Batched row encoders (row-major (rows, n) input). */
void innr_pack_binary_rows(const float *v, int64_t rows, int64_t n,
                           float threshold, uint32_t *out) {
  int64_t words = (n + 31) / 32;
  for (int64_t r = 0; r < rows; ++r)
    innr_pack_binary(v + r * n, n, threshold, out + r * words);
}

void innr_quantize_u8_rows(const float *v, int64_t rows, int64_t n,
                           float alpha, float offset, uint8_t *out) {
  for (int64_t r = 0; r < rows; ++r)
    innr_quantize_u8(v + r * n, n, alpha, offset, out + r * n);
}

void innr_pack_ternary_rows(const float *v, int64_t rows, int64_t n,
                            float threshold, uint32_t *pos, uint32_t *neg) {
  int64_t words = (n + 31) / 32;
  for (int64_t r = 0; r < rows; ++r)
    innr_pack_ternary(v + r * n, n, threshold, pos + r * words,
                      neg + r * words);
}

/* ------------------------------------------------- parallel row encoders --
 * Rows are independent, so splitting the row range across threads is
 * deterministic: output is bit-identical to the serial encoders for any
 * thread count. This is the host-side throughput path for 10M-row corpus
 * preparation (the reference is single-core by design; the runtime around
 * the device is not).
 */

typedef struct {
  const float *v;
  int64_t rows, n;
  float threshold, alpha, offset;
  uint32_t *words, *pos, *neg;
  uint8_t *codes;
  int kind; /* 0 = binary, 1 = ternary, 2 = u8 */
} enc_job;

static void *enc_worker(void *arg) {
  const enc_job *j = (const enc_job *)arg;
  switch (j->kind) {
    case 0:
      innr_pack_binary_rows(j->v, j->rows, j->n, j->threshold, j->words);
      break;
    case 1:
      innr_pack_ternary_rows(j->v, j->rows, j->n, j->threshold, j->pos,
                             j->neg);
      break;
    default:
      innr_quantize_u8_rows(j->v, j->rows, j->n, j->alpha, j->offset,
                            j->codes);
  }
  return 0;
}

#define INNR_MAX_THREADS 64

static void enc_parallel(enc_job base, int32_t n_threads) {
  if (n_threads > INNR_MAX_THREADS) n_threads = INNR_MAX_THREADS;
  if (n_threads < 1 || base.rows < n_threads * 4) { /* serial cutoff */
    enc_worker(&base);
    return;
  }
  pthread_t tids[INNR_MAX_THREADS];
  enc_job jobs[INNR_MAX_THREADS];
  int64_t words = (base.n + 31) / 32;
  int64_t chunk = (base.rows + n_threads - 1) / n_threads;
  int started = 0;
  for (int t = 0; t < n_threads; ++t) {
    int64_t r0 = (int64_t)t * chunk;
    if (r0 >= base.rows) break;
    int64_t r1 = r0 + chunk < base.rows ? r0 + chunk : base.rows;
    jobs[t] = base;
    jobs[t].rows = r1 - r0;
    jobs[t].v = base.v + r0 * base.n;
    if (base.words) jobs[t].words = base.words + r0 * words;
    if (base.pos) jobs[t].pos = base.pos + r0 * words;
    if (base.neg) jobs[t].neg = base.neg + r0 * words;
    if (base.codes) jobs[t].codes = base.codes + r0 * base.n;
    if (pthread_create(&tids[t], 0, enc_worker, &jobs[t]) != 0) {
      /* thread creation failed: run this chunk inline */
      enc_worker(&jobs[t]);
      tids[t] = 0;
    }
    started = t + 1;
  }
  for (int t = 0; t < started; ++t)
    if (tids[t]) pthread_join(tids[t], 0);
}

void innr_pack_binary_rows_mt(const float *v, int64_t rows, int64_t n,
                              float threshold, uint32_t *out,
                              int32_t n_threads) {
  enc_job j = {v, rows, n, threshold, 0, 0, out, 0, 0, 0, 0};
  enc_parallel(j, n_threads);
}

void innr_pack_ternary_rows_mt(const float *v, int64_t rows, int64_t n,
                               float threshold, uint32_t *pos, uint32_t *neg,
                               int32_t n_threads) {
  enc_job j = {v, rows, n, threshold, 0, 0, 0, pos, neg, 0, 1};
  enc_parallel(j, n_threads);
}

void innr_quantize_u8_rows_mt(const float *v, int64_t rows, int64_t n,
                              float alpha, float offset, uint8_t *out,
                              int32_t n_threads) {
  enc_job j = {v, rows, n, 0, alpha, offset, 0, 0, 0, out, 2};
  enc_parallel(j, n_threads);
}

/* ------------------------------------------------------------- hamming --
 * Packed-word Hamming for host-side verification / small scans.
 */
uint64_t innr_hamming_words(const uint32_t *a, const uint32_t *b, int64_t w) {
  uint64_t acc = 0;
  for (int64_t i = 0; i < w; ++i)
    acc += (uint64_t)__builtin_popcount(a[i] ^ b[i]);
  return acc;
}

void innr_hamming_scan(const uint32_t *query, const uint32_t *corpus,
                       int64_t rows, int64_t w, uint32_t *out) {
  for (int64_t r = 0; r < rows; ++r) {
    uint64_t acc = 0;
    const uint32_t *row = corpus + r * w;
    for (int64_t i = 0; i < w; ++i)
      acc += (uint64_t)__builtin_popcount(row[i] ^ query[i]);
    out[r] = (uint32_t)acc;
  }
}

/* ------------------------------------------------------------- minhash --
 * MinHash sketch encoder: one u32 sketch row per document from its set of
 * 64-bit items (shingle hashes). Per-slot hash is splitmix64 seeded by the
 * slot number; the sketch slot is the minimum top-32-bits over the items.
 * The NumPy fallback in loader.py mirrors this BIT-FOR-BIT so sketches
 * from either encoder are interchangeable.
 */
static inline uint64_t innr_splitmix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

void innr_minhash_rows(const uint64_t *items, const int64_t *offsets,
                       int64_t n_docs, int32_t n_slots, uint32_t *out) {
  for (int64_t d = 0; d < n_docs; ++d) {
    const uint64_t *it = items + offsets[d];
    int64_t m = offsets[d + 1] - offsets[d];
    uint32_t *row = out + d * n_slots;
    for (int32_t s = 0; s < n_slots; ++s) {
      uint64_t seed = 0x9E3779B97F4A7C15ULL * (uint64_t)(s + 1);
      uint32_t best = 0xFFFFFFFFu; /* empty doc -> all-max sketch */
      for (int64_t i = 0; i < m; ++i) {
        uint32_t h = (uint32_t)(innr_splitmix64(it[i] + seed) >> 32);
        if (h < best) best = h;
      }
      row[s] = best;
    }
  }
}

typedef struct {
  const uint64_t *items;
  const int64_t *offsets;
  int64_t n_docs;
  int32_t n_slots;
  uint32_t *out;
} mh_job;

static void *mh_worker(void *arg) {
  const mh_job *j = (const mh_job *)arg;
  innr_minhash_rows(j->items, j->offsets, j->n_docs, j->n_slots, j->out);
  return 0;
}

void innr_minhash_rows_mt(const uint64_t *items, const int64_t *offsets,
                          int64_t n_docs, int32_t n_slots, uint32_t *out,
                          int32_t n_threads) {
  if (n_threads > INNR_MAX_THREADS) n_threads = INNR_MAX_THREADS;
  if (n_threads < 2 || n_docs < n_threads * 4) {
    innr_minhash_rows(items, offsets, n_docs, n_slots, out);
    return;
  }
  pthread_t tids[INNR_MAX_THREADS];
  mh_job jobs[INNR_MAX_THREADS];
  int64_t chunk = (n_docs + n_threads - 1) / n_threads;
  int started = 0;
  for (int t = 0; t < n_threads; ++t) {
    int64_t d0 = (int64_t)t * chunk;
    if (d0 >= n_docs) break;
    int64_t d1 = d0 + chunk < n_docs ? d0 + chunk : n_docs;
    jobs[t].items = items;
    jobs[t].offsets = offsets + d0;
    jobs[t].n_docs = d1 - d0;
    jobs[t].n_slots = n_slots;
    jobs[t].out = out + d0 * n_slots;
    if (pthread_create(&tids[t], 0, mh_worker, &jobs[t]) != 0) {
      mh_worker(&jobs[t]);
      tids[t] = 0;
    }
    started = t + 1;
  }
  for (int t = 0; t < started; ++t)
    if (tids[t]) pthread_join(tids[t], 0);
}

/* ABI version for the ctypes loader. v3: +minhash sketch encoder. */
int32_t innr_native_abi_version(void) { return 3; }
