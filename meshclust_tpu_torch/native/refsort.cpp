// Reference-faithful sort permutations (Trainer::split, SURVEY C5).
//
// The reference orders candidate points with std::sort under comparators on
// integer distances (Trainer.cpp:672-700). std::sort is UNSTABLE: the final
// permutation within tied keys depends on libstdc++'s introsort swap
// sequence. Those tie orders decide the sampled training pairs, so CLSTR
// bit-parity with a reference binary built on this machine requires the
// SAME algorithm on the SAME initial order — std::sort is header-inlined,
// so compiling this helper with the local g++ reproduces it exactly.
// The control flow of introsort depends only on comparator outcomes and n,
// so sorting an index array under key[idx] mirrors sorting the reference's
// Point* array under distance() element-for-element.
#include <algorithm>
#include <cstdint>

extern "C" {

// In-place std::sort of idx[0..n) by key[idx] ascending.
void mc_sort_perm(int32_t* idx, const int64_t* key, int64_t n) {
    std::sort(idx, idx + n,
              [&](int32_t a, int32_t b) { return key[a] < key[b]; });
}

// Batch variant: rows of idx [p, n] each sorted by its keys row [p, n].
void mc_sort_perm_batch(int32_t* idx, const int64_t* key, int64_t p,
                        int64_t n) {
    for (int64_t i = 0; i < p; i++) {
        mc_sort_perm(idx + i * n, key + i * n, n);
    }
}

}  // extern "C"
