"""Share of the traced train steps that were a CUDA graph's replay
(`macsa_tpu_torch/train/step_graph.py`): the count `replayed` of the port's
root span `train_step` (1 on a replay, 0 on an eager call), as a mean over
the traced steps (the card-only stretch's and the host-traced one's), in %.
None where the program has no spans or its root span carries no such
count (a program without graphs)."""


def read(r: dict):
    try:
        from macsa_tpu_torch.utils.logging import SPANS
    except ImportError:  # a program without spans
        return None
    per_step = SPANS.per_step("train_step", "replayed")
    return 100.0 * sum(per_step) / len(per_step) if per_step else None
