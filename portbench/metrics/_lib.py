"""What the per-layer readers share: kernel families by name, device time
a frame or step, the idle share.  A reader returns None where the trace
holds no record to read, never 0."""


def k1(k) -> bool:
    """K1: every entry of ops/render_kernel (csrc/render*_kernel.cu)."""
    return "render_kernel" in k.name


def k2(k) -> bool:
    """K2: ops/surface_kernel (csrc/surface_kernel.cu)."""
    return "surface_kernel" in k.name


def scatter(k) -> bool:
    """The parameter scatter: the kernels ``aten::index_add_`` launched
    (ops/scene_vjp.segment_add and the colour rows' scatter)."""
    return k.op == "aten::index_add_"


def per_unit_ms(tr, pred):
    """Device ms a frame or step of the records ``pred`` picks."""
    if not tr.units or not tr.count(pred):
        return None
    return 1e3 * tr.device_s(pred) / tr.units


def idle_pct(tr):
    if not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
