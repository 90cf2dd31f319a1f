"""The selective-scan kernel's share of its roofline in prefill: the
bytes of its interface at the prompts' true lengths (a, b, y and the
states, once) at HBM's 3.35 TB/s, over its device time in the traced
window."""
from portbench import roofline as R

KERNELS = r"ssm_scan_kernel"


def read(run):
    if run.trace is None:
        return None
    secs, names = run.trace.kernel_s(KERNELS)
    run.log(f"ssm_scan_roofline.prefill kernels: {names}")
    lens = [n for s in run.traced for n in s.prefill_lens]
    if not secs or not lens:
        return None
    return 100.0 * R.bound_s(0.0, R.ssm_scan_bytes(run.cfg, lens)) / secs
