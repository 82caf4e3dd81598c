"""``az_sim_step``'s share of its roofline at the self-play batch: the
bound from shapes (``counts.sim_step_bound``) over the kernel's mean
device time a launch in the traced stretch, in %."""

from azbench import counts

KERNEL = "sim_step_kernel"


def read(run):
    hit = run.profile.kernel(KERNEL) if run.profile else None
    if hit is None:
        return None
    bound, _ = counts.sim_step_bound(run.game, run.data["batch"],
                                     run.mcts["num_simulations"])
    return 100.0 * bound / hit[1]
