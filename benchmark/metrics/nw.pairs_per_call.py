"""How full the aligner's batches are (ops.align_device.DeviceAligner
.identities): the counter `nw_pairs` over the counter `nw_calls` (calls
with at least one pair), over the window."""


def read(run):
    calls = run.counters.get("nw_calls", 0.0)
    if not calls or "nw_pairs" not in run.counters:
        return None
    return run.counters["nw_pairs"] / calls
