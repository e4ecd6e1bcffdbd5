"""The chunked KDA core's kernel calls a train step: the launches of
`kda_chunk_kernel` (`macsa_tpu_torch/csrc/kda_core.cu`) in the traced
stretch's device trace over the stretch's steps.  Every call of the core's
kernels, forward or backward, launches it once, whatever else the call
launches, so the count is the calls: each KDA layer's forward, its
backward's recomputation (once a slice of sequences) and autograd's
backward of that.  None where the trace holds none (a program whose core
has no kernels)."""

KDA_CALL_KERNEL = "kda_chunk_kernel"


def read(r: dict):
    t = r["trace"]
    n, _ = t.matching(KDA_CALL_KERNEL)
    return n / t.steps if n and t.steps else None
