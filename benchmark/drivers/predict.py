"""Calls of a fitted estimator's predictor on new cells: set-up fits
``DensityEstimator(**estimator)`` on the configuration's cells made from
the seed and makes ``query_batches`` batches of ``query_cells`` new cells
of the same mixture on the device; the window calls the predictor on
them in turn, synchronising each call's result, until ``seconds`` have
passed (the window ends at the end of a call).

``predict_cells_per_s``: the cells of every call over the window's
length.  The comparison holds the set-up fit to the reference as the fit
driver does, and the last answer on each batch to the reference's
predictor from that fit's landmarks."""

import time

import torch

from benchmark import fitcheck
from benchmark.data import mixture, new_cells

PROFILED_CALLS = 200


def setup(ctx):
    import mellon_tpu_torch as mt

    cfg, tr = ctx.config, ctx.traffic
    x, centres, scales = mixture(cfg["cells"], cfg["dims"], ctx.seed)
    est = mt.DensityEstimator(device=ctx.device, **cfg.get("estimator", {}))
    est.fit(x)
    queries = [torch.as_tensor(new_cells(centres, scales, tr["query_cells"], [ctx.seed, 1 + i]),
                               device=ctx.device) for i in range(tr["query_batches"])]
    predictor = est.predict
    for q in queries:
        predictor(q)
    ctx.sync()
    ctx.state.update(x=x, est=est, predictor=predictor, queries=queries)


def window(ctx):
    s = ctx.state
    predictor, queries = s["predictor"], s["queries"]
    last = [None] * len(queries)
    calls = cells = 0
    t0 = time.perf_counter()
    while True:
        i = calls % len(queries)
        with ctx.span("predict.call"):
            out = predictor(queries[i])
            ctx.sync()
        last[i] = out
        calls += 1
        cells += queries[i].shape[0]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    n, d = queries[0].shape
    ctx.record["shapes"] = {"queries": n, "landmarks": s["est"].landmarks.shape[0], "dims": d}
    s["last"] = last
    ctx.state["attempted"] = calls
    ctx.state["failed"] = sum(not bool(torch.isfinite(o).all()) for o in last if o is not None)
    return {"predict_cells_per_s": cells / elapsed}


def profile(ctx):
    predictor, queries = ctx.state["predictor"], ctx.state["queries"]
    with ctx.profiled():
        for i in range(PROFILED_CALLS):
            with ctx.span("predict.call"):
                predictor(queries[i % len(queries)])
                ctx.sync()


def collect(ctx):
    s = ctx.state
    outputs = {"fit": fitcheck.fit_outputs(s["est"], ctx.seed, ctx.config),
               "answers": [(i, o.detach().cpu()) for i, o in enumerate(s["last"]) if o is not None],
               "queries": [q.cpu() for q in s["queries"]]}
    for key in ("est", "predictor", "last", "queries"):
        s.pop(key, None)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    return outputs


def control(ctx, outputs):
    """The control's outputs in place of the program's: its fit from the
    same cells and landmarks, and its predictor's answers."""
    fit, model = fitcheck.control_fit(ctx.state["x"], outputs["fit"], ctx.device,
                                      torch.zeros_like(outputs["fit"]["z"]))
    answers = [(i, model.predict(outputs["queries"][i], fit["z"]).cpu())
               for i, _ in outputs["answers"]]
    return dict(outputs, fit=fit, answers=answers)


def check(ctx, outputs):
    fit = outputs["fit"]
    model = fitcheck.reference_model(ctx.state["x"], fit["landmarks"], ctx.device)
    z_ref = model.newton_map(fit["z"])
    numbers = fitcheck.fit_numbers(fit, model, z_ref)
    gaps = []
    for i, answer in outputs["answers"]:
        want = model.predict(outputs["queries"][i], z_ref)
        spread = float(want.max() - want.min())
        gaps.append(float((answer.to(want.device, torch.float64) - want).abs().max()) / spread)
    numbers["pred_gap"] = max(gaps) if gaps else float("nan")
    return list(numbers.items())
