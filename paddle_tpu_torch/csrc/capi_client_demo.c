/* Pure-C client of the inference C API (pt_c_api.h) — the analog of the
 * reference's non-Python inference clients (go/paddle/predictor.go).
 * A copy of the JAX package's csrc/capi_client_demo.c, with a second
 * mode for artifacts with several feeds of any dtype.
 *
 * Usage: capi_client_demo <artifact_dir> <n_floats> [v0 v1 ...]
 *   Feeds one float32 tensor of shape [1, n_floats] (values from argv or
 *   a ramp), prints each output as "OUT <i> <dtype> <ndim> <shape...>:"
 *   followed by up to 8 leading values.
 * Usage: capi_client_demo <artifact_dir> --raw <in_dir> <out_dir> [reps]
 *   Reads input i from <in_dir>/in<i>.bin: a header of int32 dtype, int32
 *   ndim and ndim int64 extents, then the raw bytes; runs the predictor
 *   reps times (default 1), printing "MS_PER_RUN <ms>" of the runs after
 *   the first; writes output i to <out_dir>/out<i>.bin in the same
 *   format, its bytes as the predictor returned them (bf16 as raw words).
 * The tests parse the output and compare it with SerializedPredictor on
 * the same feeds. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "pt_c_api.h"

#define MAX_INPUTS 16
static const size_t kItem[] = {4, 4, 8, 8, 1, 2, 2, 1};

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static size_t count_of(const PT_Tensor *t) {
  size_t n = 1;
  for (int d = 0; d < t->ndim; ++d) n *= (size_t)t->shape[d];
  return n;
}

/* the --raw mode: every feed from a file, every fetch to a file */
static int run_raw(const char *dir, const char *in_dir, const char *out_dir,
                   int reps) {
  PT_Predictor *p = PT_NewPredictor(dir);
  if (!p) {
    fprintf(stderr, "create failed: %s\n", PT_GetLastError());
    return 1;
  }
  int n_in = PT_GetInputNum(p);
  PT_Tensor ins[MAX_INPUTS];
  char path[4096];
  if (n_in < 0 || n_in > MAX_INPUTS) {
    fprintf(stderr, "too many inputs: %d\n", n_in);
    return 1;
  }
  for (int i = 0; i < n_in; ++i) {
    snprintf(path, sizeof path, "%s/in%d.bin", in_dir, i);
    FILE *f = fopen(path, "rb");
    int hdr[2];
    if (!f || fread(hdr, sizeof(int), 2, f) != 2 || hdr[1] < 0 ||
        hdr[1] > PT_MAX_DIMS || hdr[0] < 0 || hdr[0] > PT_BOOL) {
      fprintf(stderr, "bad input file %s\n", path);
      return 1;
    }
    ins[i].dtype = hdr[0];
    ins[i].ndim = hdr[1];
    if (fread(ins[i].shape, sizeof(int64_t), (size_t)hdr[1], f) !=
        (size_t)hdr[1]) {
      fprintf(stderr, "bad input shape in %s\n", path);
      return 1;
    }
    size_t bytes = count_of(&ins[i]) * kItem[hdr[0]];
    ins[i].data = malloc(bytes ? bytes : 1);
    if (fread(ins[i].data, 1, bytes, f) != bytes) {
      fprintf(stderr, "short input data in %s\n", path);
      return 1;
    }
    fclose(f);
  }
  PT_Tensor outs[8];
  int n_out = -1;
  double t0 = 0.0;
  for (int r = 0; r < (reps > 0 ? reps : 1); ++r) {
    if (r == 1) t0 = now_ms();
    n_out = PT_PredictorRun(p, ins, n_in, outs, 8);
    if (n_out < 0) {
      fprintf(stderr, "run failed: %s\n", PT_GetLastError());
      return 1;
    }
  }
  if (reps > 1) printf("MS_PER_RUN %.4f\n", (now_ms() - t0) / (reps - 1));
  for (int i = 0; i < n_out; ++i) {
    snprintf(path, sizeof path, "%s/out%d.bin", out_dir, i);
    FILE *f = fopen(path, "wb");
    int hdr[2] = {outs[i].dtype, outs[i].ndim};
    fwrite(hdr, sizeof(int), 2, f);
    fwrite(outs[i].shape, sizeof(int64_t), (size_t)outs[i].ndim, f);
    fwrite(outs[i].data, 1, count_of(&outs[i]) * kItem[outs[i].dtype], f);
    fclose(f);
  }
  printf("outputs=%d\n", n_out);
  for (int i = 0; i < n_in; ++i) free(ins[i].data);
  PT_DeletePredictor(p);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 5 && strcmp(argv[2], "--raw") == 0)
    return run_raw(argv[1], argv[3], argv[4], argc > 5 ? atoi(argv[5]) : 1);
  if (argc < 3) {
    fprintf(stderr, "usage: %s <artifact_dir> <n_floats> [values...]\n",
            argv[0]);
    return 2;
  }
  const char *dir = argv[1];
  int n = atoi(argv[2]);
  float *vals = (float *)malloc(sizeof(float) * (size_t)n);
  for (int i = 0; i < n; ++i)
    vals[i] = (argc > 3 + i) ? (float)atof(argv[3 + i]) : 0.01f * (float)i;

  PT_Predictor *p = PT_NewPredictor(dir);
  if (!p) {
    fprintf(stderr, "create failed: %s\n", PT_GetLastError());
    return 1;
  }
  printf("inputs=%d outputs=%d in0=%s\n", PT_GetInputNum(p),
         PT_GetOutputNum(p), PT_GetInputName(p, 0));

  PT_Tensor in;
  in.dtype = PT_FLOAT32;
  in.ndim = 2;
  in.shape[0] = 1;
  in.shape[1] = n;
  in.data = vals;

  PT_Tensor outs[8];
  int n_out = PT_PredictorRun(p, &in, 1, outs, 8);
  if (n_out < 0) {
    fprintf(stderr, "run failed: %s\n", PT_GetLastError());
    PT_DeletePredictor(p);
    return 1;
  }
  for (int i = 0; i < n_out; ++i) {
    long count = 1;
    printf("OUT %d dtype=%d ndim=%d shape=", i, outs[i].dtype,
           outs[i].ndim);
    for (int d = 0; d < outs[i].ndim; ++d) {
      printf("%s%lld", d ? "x" : "", (long long)outs[i].shape[d]);
      count *= (long)outs[i].shape[d];
    }
    printf(" :");
    if (outs[i].dtype == PT_FLOAT32) {
      const float *f = (const float *)outs[i].data;
      for (long k = 0; k < count && k < 8; ++k) printf(" %.6f", f[k]);
    } else if (outs[i].dtype == PT_INT64) {
      const long long *q = (const long long *)outs[i].data;
      for (long k = 0; k < count && k < 8; ++k) printf(" %lld", q[k]);
    }
    printf("\n");
  }
  /* second run with the same predictor exercises buffer reuse */
  n_out = PT_PredictorRun(p, &in, 1, outs, 8);
  printf("second_run=%d\n", n_out);
  PT_DeletePredictor(p);
  free(vals);
  return 0;
}
