"""K2 (`ops/image_prep.py`, kernels `tile_normalize_kernel`, `unpack_normalize_word_kernel`) against its bound:
the bounds of the traced steps' two calls (images, ROI crops; bytes as
`flops/counts.k2_unpack` counts them, an empty frame's validity word only)
over the kernels' summed device time."""


def read(r: dict):
    by_batch = r.get("k2_bound_s_by_batch")
    _, seconds = r["trace"].matching("tile_normalize_kernel", "unpack_normalize_word_kernel")
    if not by_batch or not seconds:
        return None
    bound = sum(by_batch[k % len(by_batch)] for k in r["traced_ks"])
    return 100.0 * bound / seconds
