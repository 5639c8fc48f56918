"""merge_pair_roofline: the pair merge's (K2) share of its roofline
over the window: the frozen bound of every ``merge_pair`` launch
(``portbench.roofline.merge_bound_s``) over the device time of its
kernels (``merge_tile_kernel``, and ``merge_split_kernel`` where a merge
has one).  Nothing when no merge ran or when the tile kernels and the
launches do not pair one to one."""
from portbench import roofline

KERNELS = ("merge_tile_kernel", "merge_split_kernel")


def read(run):
    if run.trace is None:
        return None
    sizes = run.launch_sizes.get("merge_pair", [])
    dev = sum(run.trace.kernel_s.get(k, 0.0) for k in KERNELS)
    if not sizes or not dev or \
            run.trace.kernel_n.get("merge_tile_kernel") != len(sizes):
        return None
    return 100.0 * sum(roofline.merge_bound_s(a, b) for a, b in sizes) / dev
