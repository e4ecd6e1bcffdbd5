"""Rate of the host->card copy of a served batch: the median by batch of
the port's `h2d` span's `bytes` count (the host arrays `train/common.
to_device` sends: the f32 frames, boxes and text arrays, ~168.6 MB at
batch 8) over the median by batch of the card's seconds between the
span's two CUDA events (`macsa_tpu_torch/utils/logging.span_median`), in
GB/s (1e9 bytes).  The copies are from pageable memory.  None where the
program has no spans or recorded no events (no card)."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    sent, ms = span_median("h2d", "bytes"), span_median("h2d", "device_ms")
    if not sent or not ms:
        return None
    return sent / (ms * 1e-3) / 1e9
