"""The port's operators: the kernel wrappers and their plain versions.

Each kernel wrapper counts the launches of its kernel in ``.launches``
(and by scoring loop in ``.launches_by_loop``); a CPU tensor takes the
plain version, which counts nothing.  The helpers below read and zero
those counters for a measured window (``chip_smoke.py``,
``scripts/torch_load_test.py``).  They import the modules when called, so
importing this package stays cheap."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from photo_search_engine_tpu_torch.ops import grouped_mask, ivf_scan, quantized, topk

    return {"block_topk": topk.block_topk, "int8_block_topk": quantized.int8_block_topk,
            "grouped_block_topk": grouped_mask.grouped_block_topk,
            "int8_grouped_block_topk": quantized.int8_grouped_block_topk,
            "ivf_block_topk": ivf_scan.ivf_block_topk, "fast_block_topk": topk.fast_block_topk,
            "fast_grouped_block_topk": grouped_mask.fast_grouped_block_topk, "fused_topk": topk.fused_topk}


def reset_launches() -> None:
    """Set every wrapper's launch counters to 0."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_loop"):
            wrapper.launches_by_loop = dict.fromkeys(wrapper.launches_by_loop, 0)


def read_launches() -> dict:
    """Each wrapper's launches since the last :func:`reset_launches`."""
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}
