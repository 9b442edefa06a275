// Fixture: an extern "C" block, comments naming rt_ghost(int) and a
// string "rt_ghost(int)" that the parser must not read as prototypes.
#include "common.cuh"

/* int rt_commented_out(float x); */
static const char* kNote = "int rt_in_a_string(float x);";

extern "C" {

// out = alpha * x
int rt_scale(const float* x, float* out, float alpha, int n,
             void* stream) {
  return rt_helper_launch(x, out, alpha, n, stream);
}

}  // extern "C"
