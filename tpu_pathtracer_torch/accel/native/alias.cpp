// Walker/Vose alias-table construction, exact sequential algorithm.
//
// The Python construction in tracer/envsample.py is the correctness
// reference; at real envmap sizes (2048x1024 = 2M texels) the interpreted
// loop takes minutes, so this C implementation is the production path
// (~10 ms). It mirrors the Python loop exactly — stacks filled in ascending
// index order, popped from the top — so both produce bit-identical tables.
//
// Role parity: the reference has no envmap importance sampling at all
// (BSDF-only env lookups, the reference src/renderkernel.cu:422-437);
// this supports the env-NEE extension required by BASELINE config #2.
#include <vector>
#include <cstdint>

extern "C" int alias_build(const double* p_in, int n,
                           float* prob, int32_t* alias_out) {
    if (n <= 0) return 1;
    std::vector<double> p(p_in, p_in + n);
    std::vector<int32_t> small_s, large_s;
    small_s.reserve(n);
    large_s.reserve(n);
    for (int32_t i = 0; i < n; i++)
        (p[i] < 1.0 ? small_s : large_s).push_back(i);
    for (int32_t i = 0; i < n; i++) {
        prob[i] = 1.0f;
        alias_out[i] = i;
    }
    while (!small_s.empty() && !large_s.empty()) {
        int32_t s = small_s.back(); small_s.pop_back();
        int32_t l = large_s.back(); large_s.pop_back();
        prob[s] = (float)p[s];
        alias_out[s] = l;
        p[l] = p[l] - (1.0 - p[s]);
        (p[l] < 1.0 ? small_s : large_s).push_back(l);
    }
    return 0;
}
