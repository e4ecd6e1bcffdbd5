"""Device time of the KDA blocks' forward a train step: the card's
milliseconds between the two CUDA events of each of the port's `kda`
spans (`models/kimi_linear.py` `KimiDeltaAttention.forward`), summed over
the layers; the median over the traced steps
(`macsa_tpu_torch/utils/logging.span_median`, "device_ms").  The
backward's recomputation and products are not in it.  None where the
program has no such span or recorded no events (no card)."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    return span_median("kda", "device_ms")
