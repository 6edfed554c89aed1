"""A fine-tune: the train step that ``asltpu_torch.train.loop.make_train_step``
builds from ``TrainConfig``, on staged uint8 batches already on the card.

Set-up builds the one train state (the model from
``asltpu_torch.api.build_trainable`` with the harness's weights, AdamW,
the dropout generator seeded from the run's seed) and drives it through
its first ``check_steps`` steps with the window's own call and feed: a
ring of seeded batches and a longer ring of label rows, so that no two of
those steps see the same rows. The window then runs the same step on the
same state from a synchronisation until ``--seconds`` have passed and
ends on one: ``train_clips_per_s`` is the steps completed times the batch
over that time.

Once it has closed, a snapshot is taken of the state it left (the
parameters and AdamW's moments) and the program takes one more step on
the next batch of the feed. With the program's state freed, the
reference follows the first steps from the same weights, batches and
dropout seed, and takes the step after the window from the snapshot:
each loss, the gradient as the optimizer got it (from its first moment)
and each leaf's change are compared, leaf by leaf."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench.core import program, stats, trace, weights
from perfbench.core.harness import Context, Outcome

BETA1 = 0.9


def run(ctx: Context) -> Outcome:
    return drive(ctx)[0]


def drive(ctx: Context, extra=()) -> tuple:
    """Run the cell once: the outcome, and the raw readings of the program
    and of the reference in float32 and in each precision of ``extra``
    (:func:`readings`)."""
    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train.loop import create_train_state, make_train_step

    p, config, dev = ctx.params, ctx.config, ctx.device
    batch = p["batch"]
    ref = program.reference(config)
    with ctx.setup.part("weights"):
        params = program.params_for(config, ctx.seed, dev)
    with ctx.setup.part("build"):
        model = api.build_trainable(config["model"], device=dev,
                                    **weights.port_overrides(config["model"], config))
        weights.load_into(model.module, params)
        tcfg = TrainConfig(batch_size=batch, **p["train"])
        dropout_seed = weights.sub_seed(ctx.seed, 3)
        state = create_train_state(model.module, tcfg, seed=dropout_seed)
        step = make_train_step(tcfg, model.cfg.preprocess)
    with ctx.setup.part("batches"):
        feed = make_feed(ctx)
    named = dict(model.module.named_parameters())
    losses = []
    with ctx.setup.part("check_steps"):
        for k in range(p["check_steps"]):
            state, metrics = step(state, *feed(k))
            losses.append(float(metrics["loss"]))
            if k == 0:
                pre_clip_norm = float(metrics["grad_norm"])
                # A step that left the optimizer untouched has given it nothing.
                first_grad = weights.leaf_norms(
                    {n: moment(state, q, "exp_avg") / (1 - BETA1) for n, q in named.items()})
        after = {n: q.detach().clone() for n, q in named.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    k = p["check_steps"]
    holder: dict = {}
    steps = 0

    def steps_until(t_stop: float) -> None:
        nonlocal state, k, steps
        while True:
            with record_function("train_step"):
                state, _ = step(state, *feed(k))
            k, steps = k + 1, steps + 1
            if time.perf_counter() >= t_stop:
                return

    if ctx.trace:
        with trace.capture(holder, dev):
            t0 = ctx.setup.start_window()
            steps_until(t0 + p["trace_s"])
    else:
        t0 = ctx.setup.start_window()
    traced = steps
    if time.perf_counter() < t0 + ctx.seconds:
        steps_until(t0 + ctx.seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counters = {"steps": steps, "clips": steps * batch, "window_s": t1 - t0,
                "steps_in_slice": traced, "slice_launches": traced,
                "slice_frames": traced * batch * config["preprocess"]["num_frames"],
                "flops_per_clip": train_flops_per_clip(ref, config)}
    # One more step with the window's call and feed, from a snapshot of the
    # state the window left: the reference takes the step from the same one.
    snap = {"params": {n: q.detach().clone() for n, q in named.items()},
            "m": {n: moment(state, q, "exp_avg") for n, q in named.items()},
            "v": {n: moment(state, q, "exp_avg_sq") for n, q in named.items()},
            "count": k}
    state, metrics = step(state, *feed(k))
    post = {"post_loss": float(metrics["loss"]),
            "post_grad": weights.leaf_norms(
                {n: (moment(state, q, "exp_avg") - BETA1 * snap["m"][n]) / (1 - BETA1)
                 for n, q in named.items()}),
            "post_change": weights.leaf_norms(
                {n: q.detach() - snap["params"][n] for n, q in named.items()})}
    del state, model, step, metrics, named
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    raw = {"program": {"losses": losses, "grad": first_grad,
                       "change": weights.leaf_norms({n: after[n] - params[n] for n in after}),
                       **post}}
    del after
    # The reference follows the first steps from the same inputs, and the
    # step after the window from the snapshot.
    for precision in ("fp32", *extra):
        raw[precision] = readings(ref, params, snap, config, p, dropout_seed, feed, precision)
    numbers, where = gaps(raw["program"], raw["fp32"])
    outcome = Outcome(
        e2e={"train_clips_per_s": stats.rate(steps * batch, t1 - t0)},
        attempted=steps, failed=0,
        checks={k: (v, ctx.limit(k)) for k, v in numbers.items() if k in ctx.cell["limits"]},
        counters=counters, memory_peak_bytes=peak, trace=trace.read(holder),
        info={"steps_in_window": steps, "window_s": t1 - t0, "losses": losses,
              "first_grad_norm_before_clip": pre_clip_norm,
              "ref_losses": raw["fp32"]["losses"], "post_step": snap["count"],
              "post_loss": post["post_loss"], "ref_post_loss": raw["fp32"]["post_loss"],
              **where})
    return outcome, raw


def moment(state, q: torch.Tensor, key: str) -> torch.Tensor:
    """AdamW's ``key`` moment of parameter ``q`` (zeros before any update)."""
    m = state.optimizer.state[q].get(key)
    return torch.zeros_like(q) if m is None else m.detach().clone()


def readings(ref, params, snap: dict, config: dict, p: dict, dropout_seed: int, feed,
             precision: str = "fp32") -> dict:
    """The reference's readings in ``precision``: each loss of its first
    ``check_steps`` steps, the first gradient's leaf norms and each leaf's
    change over those steps from the harness's weights; and the loss,
    gradient and change of one step from the snapshot ``snap`` of the
    program's state after the window."""
    trainer = ref.Trainer(params, config, p["train"], dropout_seed, precision)
    losses, grad = [], None
    for j in range(p["check_steps"]):
        loss, grads = trainer.step(*feed(j))
        losses.append(loss)
        if j == 0:
            grad = weights.leaf_norms(grads)
    change = weights.leaf_norms({n: trainer.params[n].detach() - params[n]
                                 for n in trainer.names})
    del trainer, grads
    trainer = ref.Trainer({**params, **snap["params"]}, config, p["train"], dropout_seed,
                          precision)
    trainer.resume(snap["m"], snap["v"], snap["count"], p["batch"])
    post_loss, post_grads = trainer.step(*feed(snap["count"]))
    return {"losses": losses, "grad": grad, "change": change, "post_loss": post_loss,
            "post_grad": weights.leaf_norms(post_grads),
            "post_change": weights.leaf_norms({n: trainer.params[n].detach()
                                               - snap["params"][n] for n in trainer.names})}


def gaps(prog: dict, ref: dict):
    """The compared numbers of program readings against the reference's,
    and where they come from. Leaf gaps are |‖program‖ − ‖reference‖|
    against the reference's norm of the leaf or of the median leaf,
    whichever is larger, and each leaf number is the median leaf's; a
    change is compared over the leaves the reference moves (their
    gradient at least a thousandth of the median leaf's: the others move
    under AdamW by rounding alone)."""
    names = list(ref["grad"])

    def median(values):
        return sorted(values)[len(values) // 2]

    def rel(prog_n, ref_n, leaves):
        floor = median([ref_n[n] for n in leaves])
        out = {n: abs(prog_n[n] - ref_n[n]) / max(ref_n[n], floor) for n in leaves}
        return out, median(list(out.values()))

    def moving(grad):
        med = median(list(grad.values()))
        return [n for n in names if grad[n] >= 1e-3 * med]

    numbers, where = {}, {}
    for pre, grad, change in (("", "grad", "change"), ("post_", "post_grad", "post_change")):
        g_rel, numbers[pre + "grad_norm_gap"] = rel(prog[grad], ref[grad], names)
        moved = moving(ref[grad])
        d_rel, numbers[pre + "change_norm_gap"] = rel(prog[change], ref[change], moved)
        g_med = median(list(ref[grad].values()))
        worst = sorted(d_rel, key=d_rel.get, reverse=True)[:4]
        where[pre + "worst_grad_leaf"] = [max(g_rel, key=g_rel.get), max(g_rel.values())]
        # The leaves that move most apart, each with its gap and its
        # reference gradient against the median leaf's.
        where[pre + "worst_change_leaves"] = [[n, d_rel[n], ref[grad][n] / g_med]
                                              for n in worst]
        where[pre + "leaves_left_out"] = sorted(set(names) - set(moved))
    numbers["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                                   ref["losses"]))
    numbers["post_loss_gap"] = abs(prog["post_loss"] - ref["post_loss"]) / abs(ref["post_loss"])
    where["first_loss_gap"] = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return numbers, where


def control(ctx: Context, precision: str = "fp8") -> dict:
    """The compared numbers of the reference in ``precision`` put in the
    program's place, from the inputs and the snapshot a run of this seed
    makes."""
    _, raw = drive(ctx, (precision,))
    numbers, where = gaps(raw[precision], raw["fp32"])
    return {**numbers, **where}


def make_feed(ctx: Context):
    """The window's feed: step ``k`` takes batch ``k`` of a ring of seeded
    staged clips on the device (``program.smooth_clips``: frames with the
    structure of images) and label rows ``k`` of a longer ring."""
    p, config, dev = ctx.params, ctx.config, ctx.device
    batch = p["batch"]
    seed = weights.sub_seed(ctx.seed, 4)
    ring = [program.smooth_clips(batch, config, seed + j, dev) for j in range(p["ring"])]
    g = torch.Generator(dev).manual_seed(seed)
    labels = [torch.randint(0, config["num_classes"], (batch,), device=dev, generator=g)
              for _ in range(p["label_rows"])]

    def feed(k: int):
        return ring[k % len(ring)], labels[k % len(labels)]

    return feed


def train_flops_per_clip(ref, config: dict) -> float:
    """The reference's operations for one clip's forward and backward,
    without recompute, counted on the meta device."""
    from perfbench.core.arith import flops_of

    pp = config["preprocess"]
    x = torch.zeros((1, pp["num_frames"], *pp["staging_size"], 3), dtype=torch.uint8,
                    device="meta")
    params = {n: torch.zeros(s, device="meta", requires_grad=not n.endswith(("_mean", "_var")))
              for n, s, *_ in ref.param_specs(config)}

    def fwd_bwd():
        logits = ref.forward_train(x, params, config, None, recompute=False)
        torch.autograd.grad(logits.sum(), [q for q in params.values() if q.requires_grad])

    return float(flops_of(fwd_bwd))
