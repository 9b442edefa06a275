// Fixture: prototypes out of step with the table in _build.py.
// A trailing "expect: <rule>" comment marks a line the lint must flag.
extern "C" {

int rt_plain(const float* x, float* out, int n, void* stream) { return 0; }

int rt_count(const float* x, float* out, int n, int m, void* stream) {
  return 0;
}

int rt_kind(const float* x, float gamma, float* out, int n, void* stream) {
  return 0;
}

int rt_orphan(const float* x, void* stream) { return 0; }  // expect: kernel-abi

int rt_strides(const float* x, const long long* strides, void* stream) {
  return 0;
}

}  // extern "C"
