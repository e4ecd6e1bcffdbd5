from macsa_tpu_torch.parallel.mesh import (  # noqa: F401
    all_mean,
    all_reduce_gradients,
    all_sum,
    barrier,
    fetch_global,
    maybe_initialize_distributed,
    process_count,
    process_index,
    replicate,
)
