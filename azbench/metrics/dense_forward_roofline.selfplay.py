"""``az_dense_forward``'s share of its roofline at the self-play batch:
the bound from shapes (``counts.dense_forward_bound``) over the kernel's
mean device time a launch in the traced stretch, in %."""

from azbench import counts

KERNEL = "dense_forward_kernel"


def read(run):
    hit = run.profile.kernel(KERNEL) if run.profile else None
    if hit is None:
        return None
    bound, _ = counts.dense_forward_bound(run.model, run.game,
                                          run.data["batch"])
    return 100.0 * bound / hit[1]
