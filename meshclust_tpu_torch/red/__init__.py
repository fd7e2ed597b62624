"""Red (REpeat Detector) — the reference repo's sibling tool (SURVEY §2.3).

A from-scratch vectorized re-implementation of the Red pipeline:
genome k-mer table with Markov-background enrichment adjustment (R2/R3),
per-position scoring (R4), Gaussian-smoothed maxima detection for candidate
repeat regions (R6), a 2n-state transition HMM trained on candidates (R5/R7),
and Viterbi scanning with extension/merging and msk/rpt/scr outputs (R8).
"""
