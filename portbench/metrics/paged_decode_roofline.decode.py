"""The paged decode kernel's share of its roofline: the bytes each decode
needs (q, out, and the kv of each row's true context, once) at HBM's
3.35 TB/s, over the kernel's device time in the traced window."""
from portbench import roofline as R

KERNELS = r"decode(_mma)?_kernel<\d+, true"


def read(run):
    if run.trace is None:
        return None
    secs, names = run.trace.kernel_s(KERNELS)
    run.log(f"paged_decode_roofline.decode kernels: {names}")
    ctx = [c for s in run.traced for c in s.decode_ctx]
    if not secs or not ctx:
        return None
    return 100.0 * R.bound_s(0.0, R.paged_decode_bytes(run.cfg, ctx)) / secs
