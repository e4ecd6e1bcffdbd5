"""The chunked KDA core's forward against its bound: over the card-only
traced steps, the sum of each `kda_core` span's bound, max(bytes / 3.35
TB/s, FLOP / 989 TFLOP/s) of the chunked form at 64 positions a chunk over
the span's sequences and length (`flops/kimi_linear.kda_core`: q, k, v, o
in bf16, g and beta in f32, each once), over the card's milliseconds
between the spans' events (`macsa_tpu_torch/ops/kda.py` `kda_mixer`).  The
same work is counted whatever implements the core.  None where the
program has no such span, recorded no events, or the ring dropped
spans."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import SPANS
    except ImportError:  # a program without spans
        return None
    t, bound = r.get("trace"), r.get("kda_core_bound_s")
    if t is None or bound is None or SPANS.dropped:
        return None
    spans = [s for s in SPANS.spans if s.name == "kda_core" and s.step < t.steps]
    ms = [s.device_ms() for s in spans]
    if not spans or any(v is None for v in ms) or not sum(ms):
        return None
    return 100.0 * sum(bound(s.counts["seqs"], s.counts["length"]) for s in spans) / (
        1e-3 * sum(ms))
