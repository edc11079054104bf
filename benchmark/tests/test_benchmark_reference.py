"""The plain reference against independent formulations at small sizes
(CPU): PyTorch's own LSTM and Adam, explicit loops, brute-force top-k."""

import math

import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.reference import model as ref
from benchmark.reference import topk as ref_topk
from benchmark.reference import train as ref_train

E, H, D, V, L = 6, 5, 4, 50, 7


def tower(cell, readout="final"):
    return {"vocab_size": V, "embed_dim": E, "hidden": H, "encoding_dim": D, "cell": cell,
            "readout": readout, "num_layers": 1}


def params(cell, readout="final", seed=3):
    p = weights.make({"towers": ["src_tower", "tgt_tower"], "tower": tower(cell, readout)}, seed,
                     "cpu")
    for t in p.values():  # non-zero biases, so that every term is exercised
        t["layers"][0]["b"] = torch.randn_like(t["layers"][0]["b"]) * 0.3
        t["proj_b"] = torch.randn_like(t["proj_b"]) * 0.3
        if "attn_b" in t:
            t["attn_b"] = torch.randn_like(t["attn_b"]) * 0.3
    return p


def batch(b=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(2, V, (b, L), generator=gen), torch.full((b,), L)


def project(p, feats):
    out = torch.tanh(feats @ p["proj_w"] + p["proj_b"])
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def test_lstm_matches_torch_lstm():
    p = params("lstm")["src_tower"]
    tok, n = batch()
    w, b = p["layers"][0]["w"], p["layers"][0]["b"]
    lstm = torch.nn.LSTM(E, H, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w[:E].t())
        lstm.weight_hh_l0.copy_(w[E:].t())
        lstm.bias_ih_l0.copy_(b + torch.cat([torch.zeros(H), torch.ones(H), torch.zeros(2 * H)]))
        lstm.bias_hh_l0.zero_()
        _, (h, _) = lstm(p["embed"][tok])
    want = project(p, h[0])
    got = ref.encode(p, tower("lstm"), tok, n, ref.exact())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_gru_matches_an_explicit_loop():
    p = params("gru")["src_tower"]
    tok, n = batch()
    w, b = p["layers"][0]["w"].double().numpy(), p["layers"][0]["b"].double().numpy()
    x = p["embed"][tok].double().numpy()
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    h = np.zeros((x.shape[0], H))
    for t in range(L):
        g = np.concatenate([x[:, t], h], 1) @ w + b
        z, r, cand = g[:, :H], g[:, H : 2 * H], g[:, 2 * H :]
        # the reset gate scales the whole candidate pre-activation
        h = (1 - sig(z)) * np.tanh(sig(r) * cand) + sig(z) * h
    want = project({k: v.double() for k, v in p.items() if k.startswith("proj")},
                   torch.from_numpy(h))
    got = ref.encode(p, tower("gru"), tok, n, ref.exact())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell,readout", [("gru", "final"), ("lstm", "final"),
                                          ("lstm", "attention")])
def test_a_row_stops_at_its_length(cell, readout):
    p = params(cell, readout)["src_tower"]
    tok, _ = batch(b=4)
    n = torch.tensor([1, 3, 5, L])
    padded = ref.encode(p, tower(cell, readout), tok, n, ref.exact())
    for i in range(4):
        alone = ref.encode(p, tower(cell, readout), tok[i : i + 1, : n[i]], n[i : i + 1],
                           ref.exact())
        torch.testing.assert_close(padded[i : i + 1], alone, rtol=1e-5, atol=1e-6)


def test_attention_readout_by_hand():
    p = params("lstm", "attention")["src_tower"]
    tok, n = batch(b=2)
    lstm_only = dict(p)
    t = tower("lstm")
    # the states of every step, from the final readout of each prefix
    states = []
    for s in range(1, L + 1):
        x = p["embed"][tok[:, :s]]
        hs = _lstm_states(p, x)
        states.append(hs[:, -1])
    hs = torch.stack(states, 1)
    a = torch.tanh(hs @ p["attn_w"] + p["attn_b"]) @ p["attn_v"]
    alpha = torch.softmax(a, dim=1)
    feats = (alpha[:, :, None] * hs).sum(1) + hs[:, -1]
    want = project(p, feats)
    got = ref.encode(lstm_only, {**t, "readout": "attention"}, tok, n, ref.exact())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _lstm_states(p, x):
    w, b = p["layers"][0]["w"], p["layers"][0]["b"]
    h = torch.zeros(x.shape[0], H)
    c = torch.zeros_like(h)
    out = []
    for t in range(x.shape[1]):
        i, f, g, o = torch.chunk(torch.cat([x[:, t], h], 1) @ w + b, 4, dim=1)
        c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, 1)


def test_exact_topk_against_the_whole_score_matrix():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(5, 8, generator=gen)
    index = torch.randn(300, 8, generator=gen).to(torch.bfloat16)
    v, r = ref_topk.exact_topk(q, index, 290, 7, ref.exact(), block=64)
    s = q @ index[:290].float().t()
    wv, wr = torch.topk(s, 7, dim=1)
    torch.testing.assert_close(v, wv)
    assert torch.equal(r, wr)
    torch.testing.assert_close(ref_topk.row_scores(q, index, r, ref.exact()), wv)


def test_fp8_rounds_and_exact_does_not():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(ref.exact().round(x), x)
    r = ref.fp8().round(x)
    big = x.abs() > 0.1
    assert ((r - x).abs()[big] <= x.abs()[big] * 2.0 ** -4 + 1e-7).all()
    assert (r != x).any()
    a, b = torch.randn(4, 6, requires_grad=True), torch.randn(6, 3, requires_grad=True)
    ref.fp8().mm(a, b).sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
    ref.no_tf32()


def test_adam_clip_and_ema_against_torch_adam_and_a_closed_form():
    gen = torch.Generator().manual_seed(0)
    p0 = [torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen)]
    grads = [[torch.randn(3, 4, generator=gen) * 0.1, torch.randn(5, generator=gen) * 0.1]
             for _ in range(4)]
    torch_p = [x.clone().requires_grad_(True) for x in p0]
    opt = torch.optim.Adam(torch_p, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    state = ref_train.init_state({"a": p0[0], "b": p0[1]})
    history = []
    for t, g in enumerate(grads):
        for tp, gi in zip(torch_p, g):
            tp.grad = gi.clone()
        opt.step()
        state = _ref_adam(state, g, lr=0.01, decay=0.9, step_no=t)
        history.append([x.clone() for x in state["params"]])
        for got, want in zip(state["params"], torch_p):
            torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-7)
    # bias-corrected EMA: the (1 - d) d^(t - i) weighted mean of the params after each step
    w = torch.tensor([0.1 * 0.9 ** (3 - i) for i in range(4)])
    for j in range(2):
        want = sum(w[i] * history[i][j] for i in range(4)) / w.sum()
        torch.testing.assert_close(state["ema"][j], want, rtol=1e-5, atol=1e-7)


def _ref_adam(state, grads, lr, decay, step_no):
    """ref_train.step's update part, on given gradients."""
    count = state["count"] + 1
    mu = [0.1 * g + 0.9 * m for g, m in zip(grads, state["mu"])]
    nu = [0.001 * g * g + 0.999 * v for g, v in zip(grads, state["nu"])]
    c1, c2 = 1 - 0.9 ** count, 1 - 0.999 ** count
    new = [p - lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8))
           for p, m, v in zip(state["params"], mu, nu)]
    t = step_no + 1
    w_old, denom = decay * (1 - decay ** (t - 1)), 1 - decay ** t
    ema = [(w_old * e + (1 - decay) * p) / denom for e, p in zip(state["ema"], new)]
    return {"params": new, "mu": mu, "nu": nu, "ema": ema, "count": count}


def test_reference_step_clips_and_matches_the_update_rule():
    p = params("lstm", "attention")
    t = {"tower": tower("lstm", "attention")}
    gen = torch.Generator().manual_seed(5)
    targets = {"tokens": torch.randint(2, V, (40, L), generator=gen), "lengths":
               torch.randint(1, L + 1, (40,), generator=gen)}
    cache = ref.encode_blocks(p["tgt_tower"], t["tower"], targets["tokens"], targets["lengths"],
                              ref.exact())
    b = {"tokens": torch.randint(2, V, (4, L), generator=gen), "lengths": torch.full((4,), L),
         "labels": torch.tensor([0, 5, 9, 30]), "weight": torch.ones(4)}
    cfg = {"learning_rate": 0.003, "max_gradient_norm": 1e-2, "ema_decay": 0.999,
           "loss": {"scale": 20.0, "num_negatives": 3, "num_hard_negatives": 2}}
    state = ref_train.init_state(p)
    new, value, g_norm = ref_train.step(state, p, t, cfg, b, targets, cache, 11, 0, ref.exact())
    assert math.isfinite(value) and g_norm > 1e-2
    # Adam's first step moves each element whose gradient is well above eps by lr
    for old, nw, m in zip(state["params"], new["params"], new["mu"]):
        moved = m.abs() > 1e-6
        torch.testing.assert_close((old - nw).abs()[moved], torch.full_like(old[moved], 0.003),
                                   rtol=1e-3, atol=1e-7)
    # the clip: the global norm of the first moment is (1 - b1) x the clip
    mu_norm = math.sqrt(sum(float((m * m).sum()) for m in new["mu"]))
    assert mu_norm == pytest.approx(0.1 * 1e-2, rel=1e-5)
    # the mined rows: the best-scoring wrong targets
    src = ref.encode(p["src_tower"], t["tower"], b["tokens"], b["lengths"], ref.exact())
    mined = ref_train.mine(src, cache, b["labels"], 2, ref.exact()).reshape(4, 2)
    s = src @ cache.t()
    s[torch.arange(4), b["labels"]] = -float("inf")
    assert torch.equal(mined, torch.topk(s, 2, dim=1).indices)


def test_uniform_negatives_follow_the_seeded_rule():
    a = ref_train.uniform_negatives(7, 3, 100, 5, "cpu")
    g = torch.Generator().manual_seed((7 << 32) | 3)
    assert torch.equal(a, torch.randint(0, 100, (5,), generator=g))


def test_norm_gaps_take_the_larger_of_leaf_and_median():
    ref_l = [torch.ones(4), torch.ones(4) * 10, torch.ones(4) * 1e-9]
    prog = [torch.ones(4) * 1.1, torch.ones(4) * 10, torch.ones(4)]
    gapv = ref_train.norm_gaps(prog, ref_l, [True, True, False])
    assert gapv == pytest.approx(0.2 / 20.0)  # leaf 0: 0.2 against the median kept leaf's 20


def test_weights_match_the_program_layout():
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.train.loop import tree_leaves, tree_map
    from benchmark.drivers import program_model
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "qna-lstm-h128.json")
    with open(path) as f:
        config = json.load(f)
    _, model_cfg, model = program_model(config)
    ours = weights.make(model, 9, "cpu")
    theirs = sse.init_params(model_cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]  # noqa: E731
    assert shapes(ours) == shapes(theirs)
    assert tree_map(lambda x: x.dtype, ours) == tree_map(lambda x: x.dtype, theirs)
    again = weights.make(model, 9, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours), tree_leaves(again)))


def test_traffic_sizes_are_the_same_multiset_for_every_seed():
    dist = {"kind": "lognormal", "median": 6, "sigma": 0.747, "min": 1, "max": 50}
    x = traffic.quantile_lengths(dist, 10000)
    assert int(x.median()) == 6 and int(x.min()) >= 1 and int(x.max()) <= 50
    assert 0.04 < float((x > 20).float().mean()) < 0.06
    a = traffic.shuffled(x, traffic.host_gen(1, 0))
    b = traffic.shuffled(x, traffic.host_gen(2, 0))
    assert not torch.equal(a, b) and torch.equal(a.sort().values, b.sort().values)
    u = traffic.quantile_lengths({"kind": "uniform", "min": 5, "max": 30}, 26 * 4)
    assert torch.equal(torch.bincount(u)[5:], torch.full((26,), 4))
    t = traffic.tokens(torch.tensor([1, 3]), 5, {"min": 2, "max": 9}, torch.Generator(), "cpu")
    assert (t[0, 1:] == 0).all() and (t[1, 3:] == 0).all() and (t[:, 0] >= 2).all()
