"""Faults planted in the timed path, each of which a cell's comparison
has to read as not correct: ``benchmark/tests/test_bench_faults.py``
plants them on the CPU at a tiny size, ``control.py --fault <name>`` on
the chip at a cell's own size.  The benchmark's own runs never plant one.

Each fault takes ``patch(owner, name, value)`` (``setattr``, or pytest's
``monkeypatch.setattr``) and replaces a function of the program with a
broken one."""

import torch


def _halved(t):
    """The first half of the cells twice over: a sum over the cells that
    leaves half of them out and counts the rest double (their mean)."""
    half = t[: t.shape[0] // 2]
    return torch.cat([half, half])


def fit_state_unchanged(patch):
    """The optimizer returns its start."""
    from mellon_tpu_torch.models.density import DensityEstimator

    def run_inference(self, *args, **kwargs):
        self.pre_transformation = self.initial_value
        return self.pre_transformation

    patch(DensityEstimator, "run_inference", run_inference)


def fit_half_the_cells(patch):
    """The optimizer's loss over half of the cells, counted double."""
    from mellon_tpu_torch.inference.losses import density_loss
    from mellon_tpu_torch.models.density import DensityEstimator

    run_inference = DensityEstimator.run_inference

    def halved(self, *args, **kwargs):
        self._set_loss(density_loss, (_halved(self.L), _halved(self.nn_distances), self.d,
                                      self.mu))
        return run_inference(self, *args, **kwargs)

    patch(DensityEstimator, "run_inference", halved)


def fit_answer_altered(patch):
    """One cell's log density altered where it is produced."""
    from mellon_tpu_torch.models.density import DensityEstimator

    process = DensityEstimator.process_inference

    def altered(self, *args, **kwargs):
        process(self, *args, **kwargs)
        self.log_density_x = self.log_density_x.clone()
        self.log_density_x[0] += 1.0
        return self.log_density_x

    patch(DensityEstimator, "process_inference", altered)


def fit_wrong_pivots(patch):
    """The pruned landmarks are the first candidates in k-means's order,
    as many as the pivoted selection keeps, not the pivots (the fused
    prepare's selection and the lazy chain's)."""
    from mellon_tpu_torch.inference import conditionals
    from mellon_tpu_torch.models import fused

    def first(select):
        return lambda K, *args, **kwargs: torch.arange(
            len(select(K, *args, **kwargs)), device=K.device)

    patch(fused, "_pruned_pivots", first(fused._pruned_pivots))
    patch(conditionals, "select_stable_landmarks", first(conditionals.select_stable_landmarks))


def _predictor_fault(patch, fault):
    from mellon_tpu_torch.models.density import DensityEstimator

    predict = DensityEstimator.predict

    def wrapped(self):
        inner = predict.fget(self)
        return lambda X: fault(inner, X)

    patch(DensityEstimator, "predict", property(wrapped))


def predict_half_the_batch(patch):
    """The predictor answers the first half of the batch twice."""
    def halved(inner, X):
        half = inner(X[: X.shape[0] // 2])
        return torch.cat([half, half])

    _predictor_fault(patch, halved)


def predict_answer_altered(patch):
    """One answer of the predictor altered where it is produced."""
    def altered(inner, X):
        out = inner(X).clone()
        out[0] += 1.0
        return out

    _predictor_fault(patch, altered)


def _resume_fault(patch, fault):
    from mellon_tpu_torch.inference import mcmc

    resume = mcmc.resume_mcmc
    patch(mcmc, "resume_mcmc", lambda *a, **k: fault(resume(*a, **k), a))


def nuts_state_unchanged(patch):
    """The sampler returns its state."""
    def unchanged(res, args):
        z0 = torch.atleast_2d(args[1])
        samples = z0[:, None, :].expand_as(res.samples).clone()
        potential = res.potential[:, :1].expand_as(res.potential).clone()
        return res._replace(samples=samples, potential=potential)

    _resume_fault(patch, unchanged)


def nuts_half_the_cells(patch):
    """The sampler's potential over half of the cells, counted double."""
    from mellon_tpu_torch.inference import mcmc

    centre = mcmc.zero_centered_potential

    def halved(fn, z0, args):
        L, nn, *rest = args
        return centre(fn, z0, (_halved(L), _halved(nn), *rest))

    patch(mcmc, "zero_centered_potential", halved)


def nuts_answer_altered(patch):
    """One draw altered where it is produced."""
    def altered(res, args):
        samples = res.samples.clone()
        samples[0, 0] += 1.0
        return res._replace(samples=samples)

    _resume_fault(patch, altered)


def mesh_without_the_cells_reduce(patch):
    """The window's sampler (``resume_mcmc``) sums the cell-sharded
    potential over this rank's cells alone: the ``all_reduce`` over the
    mesh's cells axis left out, so each rank samples from its own block
    of the cells."""
    from mellon_tpu_torch.inference import losses, mcmc

    reduce, resume = losses._reduce_likelihood, mcmc.resume_mcmc
    sampling = []

    def local(likelihood, grad_likelihood, group):
        if sampling:
            return likelihood, grad_likelihood
        return reduce(likelihood, grad_likelihood, group)

    def resumed(*args, **kwargs):
        sampling.append(True)
        try:
            return resume(*args, **kwargs)
        finally:
            sampling.pop()

    patch(losses, "_reduce_likelihood", local)
    patch(mcmc, "resume_mcmc", resumed)


def mesh_without_the_chains_gather(patch):
    """The samplers' results are not gathered over the mesh's chains axis:
    each rank keeps its own block of the chains in every chain group's
    place, so rank 0 holds its own group's draws twice and the other
    group's not at all (half of the chains left out, the rest counted
    double)."""
    from mellon_tpu_torch.inference import mcmc

    fields = ("samples", "potential", "accept_prob", "diverging", "num_leapfrog")

    def kept(result, sharding):
        return result._replace(**{f: torch.cat([getattr(result, f)] * sharding.size)
                                  for f in fields})

    patch(mcmc, "_gather_result", kept)


def mesh_chain_group_frozen(patch):
    """The window's sampler returns the last chain group's chains at the
    state they started from (their potential the block's first), the
    other group's as sampled: a chain group that never moves, which the
    pooled draws' moments barely show."""
    def frozen(res, args):
        rest = res.samples.shape[0] // 2
        z0 = torch.atleast_2d(args[1])
        samples, potential = res.samples.clone(), res.potential.clone()
        samples[rest:] = z0[rest:, None, :]
        potential[rest:] = potential[rest:, :1]
        return res._replace(samples=samples, potential=potential)

    _resume_fault(patch, frozen)
