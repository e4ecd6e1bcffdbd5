"""Device time of the visual layer a train step from pixels: K2 and the
frozen ResNet-152 over the step's images and ROI crops (`steps.visual_features`).

The median over the traced steps (the card-only stretch's and the
host-traced one's) of the card's milliseconds between the two CUDA events
of the port's `visual` span (`macsa_tpu_torch/utils/logging.span_median`,
"device_ms"): from when the stream reached the span's start to when it
reached its end, idle gaps in between included.  None where the program
has no spans or recorded no events (no card)."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import span_median
    except ImportError:  # a program without spans
        return None
    return span_median("visual", "device_ms")
