"""The flash attention kernel's share of its roofline in prefill: the
larger of the causal operations and the bytes of q, k, v and out, at the
prompts' true lengths, over the kernel's device time in the traced
window."""
from portbench import roofline as R

KERNELS = r"flash(_mma)?_kernel<"


def read(run):
    if run.trace is None:
        return None
    secs, names = run.trace.kernel_s(KERNELS)
    run.log(f"flash_roofline.prefill kernels: {names}")
    lens = [n for s in run.traced for n in s.prefill_lens]
    if not secs or not lens:
        return None
    return 100.0 * R.bound_s(*R.flash_prefill(run.cfg, lens)) / secs
