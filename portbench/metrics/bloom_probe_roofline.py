"""bloom_probe_roofline: the bloom probe's (K1) share of its roofline
over the window: the frozen bound of every ``bloom_probe`` launch
(``portbench.roofline.probe_bound_s``, from its keys and filter words)
over the device time of ``bloom_probe_kernel``.  Nothing when no probe ran
or when the profiler's kernels and the launches do not pair one to one."""
from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    sizes = run.launch_sizes.get("bloom_probe", [])
    dev = run.trace.kernel_s.get("bloom_probe_kernel", 0.0)
    if not sizes or not dev or \
            run.trace.kernel_n.get("bloom_probe_kernel") != len(sizes):
        return None
    return 100.0 * sum(roofline.probe_bound_s(n, w) for n, w in sizes) / dev
