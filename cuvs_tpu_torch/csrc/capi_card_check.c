/* Exact k-NN through the C ABI on the CUDA card.
 *
 *   capi_card_check BASE.fbin QUERIES.fbin METRIC K OUT_IDS OUT_SECONDS
 *
 * Reads the rows and the queries (.fbin: int32 rows, int32 dim, float32
 * payload), calls cuvsTpuInit("gpu"), builds a brute-force index of the rows
 * with cuvsTpuIndexBuild and searches every query with cuvsTpuIndexSearch
 * and params {"fused": true}, which runs the exact fused kernel: once to warm
 * up, once timed (to cuvsTpuSync). Writes the timed search's ids (int32,
 * row-major) to OUT_IDS and its seconds to OUT_SECONDS. Exit code 0 on
 * success, 1 on a failed call (its message on stderr), 2 on bad arguments. */
#include "cuvs_tpu.h"

#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#define CHECK(expr)                                                   \
  do {                                                                \
    if ((expr) != CUVS_TPU_SUCCESS) {                                 \
      fprintf(stderr, "FAIL %s: %s\n", #expr, cuvsTpuGetLastError()); \
      return 1;                                                       \
    }                                                                 \
  } while (0)

static float* read_fbin(const char* path, int32_t* n, int32_t* d) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  float* rows = NULL;
  if (fread(n, 4, 1, f) == 1 && fread(d, 4, 1, f) == 1 && *n > 0 && *d > 0) {
    size_t count = (size_t)*n * (size_t)*d;
    rows = malloc(count * sizeof(float));
    if (rows && fread(rows, sizeof(float), count, f) != count) {
      free(rows);
      rows = NULL;
    }
  }
  fclose(f);
  return rows;
}

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

int main(int argc, char** argv) {
  if (argc != 7) {
    fprintf(stderr, "usage: %s BASE.fbin QUERIES.fbin METRIC K OUT_IDS OUT_SECONDS\n", argv[0]);
    return 2;
  }
  int32_t n, d, nq, dq;
  float* base = read_fbin(argv[1], &n, &d);
  float* queries = read_fbin(argv[2], &nq, &dq);
  int64_t k = atoll(argv[4]);
  if (!base || !queries || d != dq || k <= 0) {
    fprintf(stderr, "cannot read the rows and queries, or bad k\n");
    return 2;
  }
  float* out_d = malloc((size_t)nq * k * sizeof(float));
  int32_t* out_i = malloc((size_t)nq * k * sizeof(int32_t));
  if (!out_d || !out_i) return 2;

  CHECK(cuvsTpuInit("gpu"));
  cuvsTpuIndex_t index;
  CHECK(cuvsTpuIndexBuild("brute_force", argv[3], NULL, base, n, d, &index));
  const char* params = "{\"fused\": true}";
  CHECK(cuvsTpuIndexSearch(index, params, queries, nq, d, k, out_d, out_i));
  double t0 = now();
  CHECK(cuvsTpuIndexSearch(index, params, queries, nq, d, k, out_d, out_i));
  CHECK(cuvsTpuSync());
  double secs = now() - t0;
  CHECK(cuvsTpuIndexDestroy(index));

  FILE* f = fopen(argv[5], "wb");
  if (!f || fwrite(out_i, sizeof(int32_t), (size_t)nq * k, f) != (size_t)nq * k) return 1;
  fclose(f);
  f = fopen(argv[6], "w");
  if (!f) return 1;
  fprintf(f, "%.9f\n", secs);
  fclose(f);
  printf("searched %d queries over %d rows through the C ABI in %.6f s\n", nq, n, secs);
  free(base);
  free(queries);
  free(out_d);
  free(out_i);
  return 0;
}
