"""The Swin-Unet's cell, ``swin_unet_2d.train``: found by name and run on
the CPU at a tiny size through ``H.run_cell``, its counts against
independent ones, and the check rejecting each planted fault and the
control. The card's runs are ``python3 -m benchmark.run --workload
swin_unet_2d.train ...`` and the calibration of
``benchmark/drivers/train_swin.py``."""

import shutil
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults as F
from benchmark import harness as H
from benchmark.counts import swin_unet as CS
from benchmark.counts import window_attention as WA
from benchmark.drivers import train_swin
from benchmark.reference import swin_unet as RS

CELL = "swin_unet_2d.train"
# 64² in float32: the 16² and 8² stages shift, the 4² and 2² stages
# attend over their whole side
TINY = ({"DIM": [64, 64], "SWIN_EMBED_DIM": 12, "SWIN_WINDOW": 4,
         "SWIN_HEADS": [2, 2, 4, 4], "BATCHSIZE": 4,
         "MIXED_PRECISION": False}, {"patients": 2})
SEED = 2 ** 31 + 77


def _run(root, fault=None, trace=False, small=TINY):
    return H.run_cell(root, CELL, SEED, 0.3, trace, torch.device("cpu"),
                      time.time(), small[0], small[1],
                      faults={"f": fault} if fault else None)


def test_the_cell_is_found_by_name_and_runs(root):
    spec = H.benchmark_spec(root)
    cell = H.find_cell(spec, CELL)
    assert H.load_json(f"{H.HERE}/traffic/{cell['traffic']}.json")[
        "driver"] == "train_swin"
    assert H.limits_of(CELL)["control"] == "int8"
    run = _run(root, trace=True)
    assert run["correct"], run["readings"]
    assert run["images"] == 4 * run["steps"]
    e2e = H.read_metrics(spec, CELL, run, False)
    assert set(e2e) == {"train_images_per_s", "peak_mem_gib", "setup_s"}
    layer = H.read_metrics(spec, CELL, run, True)
    # the CPU trace holds no device time and no K1: the rooflines are left
    # out
    assert set(layer) == {"train.mfu_pct", "train.enqueue_ms",
                          "train.device_idle_pct", "swin.attention_device_ms"}
    spans = run["trace"]["spans"]["swin.attention"]
    assert spans["count"] == 14 * run["trace"]["steps"]


def _hand_forward_flops(cfg, batch):
    """Matrix products and convolutions of one forward, counted by hand."""
    s = RS.settings(cfg)
    e, p = s["SWIN_EMBED_DIM"], s["SWIN_PATCH"]
    h0, w0 = (d // p for d in cfg["DIM"])
    flops = 2 * batch * h0 * w0 * e * cfg["IMG_CHANNELS"] * p * p  # embed
    n = len(s["SWIN_DEPTHS"])
    for i, (h, w, m, _) in enumerate(s["stages"]):
        c, t = e * 2 ** i, batch * h * w
        windows = batch * (h // m) * (w // m)
        block = (2 * t * c * 3 * c + 2 * 2 * windows * m ** 4 * c
                 + 2 * t * c * c + 2 * 2 * t * c * s["SWIN_MLP_RATIO"] * c)
        uses = 2 if i < n - 1 else 1
        flops += uses * s["SWIN_DEPTHS"][i] * block
        if i < n - 1:
            flops += 2 * (t // 4) * 4 * c * 2 * c  # merge
            flops += 2 * t * 2 * c * c  # the decoder's concat linear
            flops += 2 * (t // 4) * 2 * c * 4 * c  # expand into stage i
    flops += 2 * batch * h0 * w0 * e * p * p * e  # the x4 expand
    flops += 2 * batch * h0 * w0 * p * p * e * cfg["MASK_CLASSES"]  # head
    return flops


def test_counts_at_a_second_shape():
    cfg = {"DIM": [96, 96], "SWIN_EMBED_DIM": 12, "SWIN_WINDOW": 3,
           "SWIN_HEADS": [2, 2, 4, 4], "IMG_CHANNELS": 1, "MASK_CLASSES": 2}
    assert [st[2:] for st in RS.settings(cfg)["stages"]] == [
        (3, 1), (3, 1), (3, 1), (3, 0)]
    assert CS.forward_flops(cfg, 3) == _hand_forward_flops(cfg, 3)
    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=True)
                  for n, s, _ in RS.param_spec(cfg)}
        counter = FlopCounterMode(display=False)
        with counter:
            RS.Forward(cfg)(params, torch.empty(5, 96, 96, 1)).sum() \
                .backward()
    assert CS.train_step_flops(cfg, 5) == counter.get_total_flops()


def test_window_attention_counts_one_block_by_hand():
    # 2 images of 16² tokens, width 12, 2 heads, 4 x 4 windows (16 an
    # image), shifted
    flops, nbytes = WA.block_work(512, 32, 12, 2, 4, 16)
    assert flops == (2 * 512 * 12 * 36 + 2 * 32 * 16 * 16 * 12
                     + 2 * 32 * 16 * 16 * 12 + 2 * 512 * 12 * 12)
    assert nbytes == 2 * (512 * 12 + 512 * 12 + 36 * 12 + 36 + 12 * 12
                          + 12 + 2 * 16 * 16 + 16 * 16 * 16)
    # the cell: 14 blocks at its batch, bound by its FLOPs
    cfg = H.load_json(f"{H.HERE}/configs/swin_unet_2d.json")["config"]
    work = WA.forward_work(cfg, cfg["BATCHSIZE"])
    assert work["flops"] / 989e12 > work["bytes"] / 3.35e12


@pytest.mark.parametrize("name,number", [
    ("unchanged", "change_median_gap"),
    ("half_batch", "logit_grad_row_worst_gap")])
def test_each_fault_reads_over_its_limit(root, name, number):
    sound = _run(root)
    assert sound["correct"]
    bad = _run(root, F.TRAIN[name])
    held = {c.name: c for c in bad["checks"]}
    assert held[number].value > held[number].limit and not bad["correct"]


def test_the_int8_control_reads_over_a_limit(root):
    ctx = H.context(root, CELL, SEED, 0, False, torch.device("cpu"),
                    time.time(), TINY[0], TINY[1])
    try:
        numbers = train_swin.control(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    checks = H.checks_from(numbers, ctx.limits)
    assert any(c.value > c.limit for c in checks), numbers




@pytest.mark.card
def test_graphed_train_steps_match_the_eager_ones(card):
    """On the card a train step runs the Swin-Unet's pieces as CUDA
    graphs, captured at the first step: two SGD steps through them against
    the same steps run eagerly, at the published widths in bfloat16, on
    the same weights and drop-path draws. The graphs replay the eager
    kernels, but a matrix product on buffers at other addresses (the
    graphs' pool) may get another cuBLAS kernel, which sums in another
    order. The first output reads 0 (held to 1e-4; bfloat16 against
    float32 reads 2e-3), the first gradient's worst leaf 0.16-0.21%, a
    relative-position bias table, whose gradient cancels to a small sum
    (held to 1%; PERF.md). The second step's output is held to a tenth of
    what the first update moved it, so a graph that read stale parameters
    would fail."""
    from cmrtpu_torch.models.hybrids import get_model

    cfg = {"MODEL_VARIANT": "swin_unet", "DIM": [224, 224],
           "MASK_CLASSES": 2, "MIXED_PRECISION": True}
    x = torch.rand(4, 224, 224, 1,
                   generator=torch.Generator().manual_seed(3)).to(card)
    state, runs, models = None, {}, {}
    for graphs in (False, True):
        with torch.device(card):
            model = get_model(cfg)
        state = state or {k: v.clone() for k, v in
                          model.state_dict().items()}
        model.load_state_dict(state)
        model.cuda_graphs = graphs
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        gen = torch.Generator(card).manual_seed(5)
        outs, grads = [], None
        for _ in range(2):
            out = model(x, generator=gen)
            opt.zero_grad(set_to_none=True)
            out.square().mean().backward()
            grads = grads or {n: p.grad.clone()
                              for n, p in model.named_parameters()}
            opt.step()
            outs.append(out.detach().clone())
        models[graphs], runs[graphs] = model, (outs, grads)
    assert models[True]._runtime.get("graphs")
    assert not models[False]._runtime.get("graphs")
    (eager, eager_grads), (graph, graph_grads) = runs[False], runs[True]

    def gap(a, b):
        return float((a - b).norm() / b.norm())

    leaves = {n: gap(graph_grads[n], eager_grads[n]) for n in eager_grads}
    moved = gap(eager[1], eager[0])
    print(f"first output {gap(graph[0], eager[0])}, first gradient's worst "
          f"leaf {max(leaves.items(), key=lambda kv: kv[1])}, second output "
          f"{gap(graph[1], eager[1])} against a step's move {moved}")
    assert gap(graph[0], eager[0]) <= 1e-4
    assert max(leaves.values()) <= 0.01
    assert gap(graph[1], eager[1]) <= 0.1 * moved
