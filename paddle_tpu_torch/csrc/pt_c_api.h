/* Public header for the paddle_tpu inference C API (csrc/capi.cc).
 *
 * Mirrors the role of Paddle's paddle_c_api.h
 * (paddle/fluid/inference/capi/paddle_c_api.h): a flat
 * C ABI non-Python hosts link against to serve a model artifact.
 */
#ifndef PT_C_API_H_
#define PT_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PT_MAX_DIMS 8

/* dtype codes (item sizes: 4,4,8,8,1,2,2,1 bytes) */
enum {
  PT_FLOAT32 = 0,
  PT_INT32 = 1,
  PT_INT64 = 2,
  PT_FLOAT64 = 3,
  PT_UINT8 = 4,
  PT_FLOAT16 = 5,
  PT_BFLOAT16 = 6,
  PT_BOOL = 7,
};

typedef struct PT_Tensor {
  int dtype;
  int ndim;
  int64_t shape[PT_MAX_DIMS];
  void *data; /* caller-owned for inputs; predictor-owned for outputs,
                 valid until the next Run or Delete */
} PT_Tensor;

typedef struct PT_Predictor PT_Predictor;

/* Load an export_serialized() artifact directory. NULL on failure —
 * consult PT_GetLastError(). */
PT_Predictor *PT_NewPredictor(const char *artifact_dir);

int PT_GetInputNum(PT_Predictor *);
int PT_GetOutputNum(PT_Predictor *);
const char *PT_GetInputName(PT_Predictor *, int i);
const char *PT_GetOutputName(PT_Predictor *, int i);

/* Run one forward. Returns the number of outputs written into `outs`
 * (at most max_out), or -1 on error. */
int PT_PredictorRun(PT_Predictor *, const PT_Tensor *ins, int n_in,
                    PT_Tensor *outs, int max_out);

/* Last error of THIS thread (thread-local storage). */
const char *PT_GetLastError(void);
void PT_DeletePredictor(PT_Predictor *);

#ifdef __cplusplus
}
#endif

#endif /* PT_C_API_H_ */
