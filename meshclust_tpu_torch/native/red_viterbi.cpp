// Two-state-per-position Viterbi for the Red scanner (HMM::decode,
// src/nonltr/HMM.cpp:455-574 semantics; the Python oracle is
// meshclust_tpu_torch/red/hmm.py:decode_states and stays the tested reference).
//
// At each position only two states are reachable: (score, positive) and
// (score, negative).  The forward sweep keeps the two path log-probs and a
// 2-bit backpointer per step; tie-breaks are strict '>' forward (the
// from-negative branch wins ties) and '>=' at the final readout (positive
// wins).  Plain double adds/compares in source order, so results are
// bit-identical to the numpy scalar loop.

#include <cstdint>

extern "C" void mc_red_viterbi(const int64_t* st, int64_t n,
                               const double* priors, const double* trans,
                               int64_t npos, uint8_t* back /* [n*2] */,
                               int64_t* states_out /* [n] */) {
    if (n <= 0) return;
    const int64_t S = 2 * npos;
    double vP = priors[st[0]];
    double vN = priors[st[0] + npos];
    for (int64_t i = 1; i < n; ++i) {
        const int64_t pp = st[i - 1], pn = pp + npos;
        const int64_t cp = st[i], cn = cp + npos;
        const double* tp = trans + pp * S;
        const double* tn = trans + pn * S;
        const double p1 = vP + tp[cp];
        const double p2 = vN + tn[cp];
        const double p3 = vP + tp[cn];
        const double p4 = vN + tn[cn];
        double nvP, nvN;
        if (p1 > p2) { nvP = p1; back[2 * i] = 0; }
        else         { nvP = p2; back[2 * i] = 1; }
        if (p3 > p4) { nvN = p3; back[2 * i + 1] = 0; }
        else         { nvN = p4; back[2 * i + 1] = 1; }
        vP = nvP;
        vN = nvN;
    }
    int64_t is_neg = (vP >= vN) ? 0 : 1;
    states_out[n - 1] = st[n - 1] + (is_neg ? npos : 0);
    for (int64_t i = n - 1; i > 0; --i) {
        is_neg = back[2 * i + is_neg];
        states_out[i - 1] = st[i - 1] + (is_neg ? npos : 0);
    }
}
