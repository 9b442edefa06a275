// Fixture: a header with a helper outside any extern "C".
static int rt_helper_launch(const float* x, float* out, float alpha, int n,
                            void* stream) {
  return 0;
}
