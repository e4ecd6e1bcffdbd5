"""Host time of the fusion a train step: `FCMFEncoder.forward`'s parts A-C
(the text->image cross-attention, the box head and the text+ROI pass, the
fusion of CLS, image and ROI tokens).

The median over the traced steps (the card-only stretch's and the
host-traced one's) of the host milliseconds a step spends in the port's
`fusion` span (`macsa_tpu_torch/utils/logging.span_median`: the span's
`time.perf_counter_ns` interval).  Spans record only while a profiler
records, so the figure carries the profiler's per-launch cost: read it
beside the cell's stretch (the traced step over the untraced one, PERF.md
§5), since a change that cuts launches cuts that cost too.  None where
the program has no spans."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    return span_median("fusion", "host_ms")
