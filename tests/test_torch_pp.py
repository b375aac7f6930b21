"""The pipelined TransHE of the port (parallel/pp.py) over 2 and 4 gloo
ranks on the CPU, against the JAX package's unsharded ``TransHE``: the
forward at (n_stages, n_micro) in {(2, 2), (4, 4), (2, 4), (4, 1)}, with a
mask and a PE table, the gradients, composed with data parallelism on a
('data', 'pipe') 2 x 2 mesh and with tensor parallelism on a ('pipe',
'model') 2 x 2 mesh, bf16, each stage's parameters and the validation
errors (tests/test_pp.py's cases and bounds: atol 1e-5 forward, 2e-6 on
the gradients, 3e-2 in bf16).

One run of the 2-rank and one of the 4-rank job of
tests/_torch_tp_worker.py (no JAX), started together, serve every test;
JAX's references are computed here meanwhile, from the same numpy inputs
and weights (DIM 12, HEADS 2, DEPTH 4, a batch of 4 x 6 tokens)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from transhuman_tpu.models.embedder import embed_vit_pos
from transhuman_tpu.models.vit import TransHE as JTransHE
from transhuman_tpu_torch.models.vit import TransHE

DIM, HEADS, DEPTH = 12, 2, 4
FWD_ATOL, GRAD_ATOL, BF16_ATOL = 1e-5, 2e-6, 3e-2


def port_sd(p) -> dict:
    """A Flax TransHE param tree as the port's TransHE state dict (Dense
    kernels (in, out) transposed, LayerNorm scale as weight)."""
    a = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    sd = {"mask_token": a(p["mask_token"]),
          "norm.weight": a(p["norm"]["scale"]),
          "norm.bias": a(p["norm"]["bias"])}
    for i in range(DEPTH):
        b = p[f"block_{i}"]
        pre = f"blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[pre + n + ".weight"] = a(b[n]["scale"])
            sd[pre + n + ".bias"] = a(b[n]["bias"])
        for src, dst in (((b["attn"]["qkv"]), "attn.qkv"),
                         ((b["attn"]["proj"]), "attn.proj"),
                         ((b["mlp_fc1"]), "mlp.fc1"),
                         ((b["mlp_fc2"]), "mlp.fc2")):
            sd[pre + dst + ".weight"] = a(src["kernel"]).T.contiguous()
            sd[pre + dst + ".bias"] = a(src["bias"])
    return sd


def _inputs(b=4, c=6, seed=0):
    model = JTransHE(embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
    rng = np.random.default_rng(seed)
    tokens = rng.normal(size=(b, c, DIM)).astype(np.float32)
    pe = rng.uniform(-1, 1, size=(b, c, 3)).astype(np.float32)
    tokens.setflags(write=False)  # shared by the cases: copied to torch
    pe.setflags(write=False)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                        jnp.asarray(pe))["params"]
    return model, params, tokens, pe


def _target(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_grads(model, params, tokens, pe, tgt):
    def loss(p):
        return jnp.mean((model.apply({"params": p}, tokens, pe) - tgt) ** 2)

    return port_sd(jax.grad(loss)(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 2-rank job's results, the 4-rank job's, JAX's references)."""
    d = tmp_path_factory.mktemp("pp")
    model, params, tokens, pe = _inputs()
    mask = np.zeros(tokens.shape[:2], bool)
    mask[:, ::2] = True
    table = np.asarray(embed_vit_pos(jnp.asarray(pe), DIM))
    tgts = {k: _target(s, tokens.shape) for k, s in
            (("tgt", 7), ("tgt_dp", 3), ("tgt_tp", 5))}
    torch.save({"sd": port_sd(params), "dim": DIM, "heads": HEADS,
                "depth": DEPTH, "tokens": torch.tensor(tokens),
                "pe": torch.tensor(pe), "table": torch.tensor(table),
                "mask": torch.from_numpy(mask),
                **{k: torch.from_numpy(v) for k, v in tgts.items()}},
               d / "pp_input.pt")
    procs = [W.spawn("pp", d, 2), W.spawn("pp", d, 4)]
    ref = {"fwd": np.asarray(model.apply({"params": params}, tokens, pe)),
           "mask_table": np.asarray(model.apply(
               {"params": params}, tokens, table, jnp.asarray(mask))),
           "bf16": np.asarray(model.clone(dtype=jnp.bfloat16).apply(
               {"params": params}, tokens, pe), np.float32)}
    for k, t in tgts.items():
        ref["grads_" + k] = _ref_grads(model, params, tokens, pe, t)
    for p in procs:
        W.join(p)
    return ([torch.load(d / f"pp2_{r}.pt", weights_only=False)
             for r in range(2)],
            [torch.load(d / f"pp4_{r}.pt", weights_only=False)
             for r in range(4)], ref, port_sd(params))


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 4), (2, 4),
                                              (4, 1)])
def test_pp_forward_matches_unsharded(runs, n_stages, n_micro):
    """Every stage holds the whole output, JAX's unsharded TransHE's."""
    res = runs[0] if n_stages == 2 else runs[1]
    for r in res:
        _close(r[f"fwd_{n_stages}_{n_micro}"], runs[2]["fwd"], FWD_ATOL,
               f"{n_stages} stages, {n_micro} microbatches")


def test_pp_forward_with_mask_and_pe_table(runs):
    for r in runs[0]:
        _close(r["mask_table"], runs[2]["mask_table"], FWD_ATOL, "mask")


def _check_grads(results, ref, n_pipe, n_other=1):
    """Each block's gradient from the rank of its stage, and mask_token's
    and norm's from every rank (whole on each), within GRAD_ATOL."""
    per = DEPTH // n_pipe
    for r, (y, g) in enumerate(results):
        stage = (r // n_other) if n_other > 1 else r
        for k, v in g.items():
            if k.startswith("blocks."):
                assert int(k.split(".")[1]) // per == stage, k
            want = ref[k]
            got = v if v is not None else torch.zeros_like(want)
            _close(got, want.numpy(), GRAD_ATOL, f"rank {r} {k}")
    blocks = {k for _, g in results for k in g if k.startswith("blocks.")}
    assert blocks == {k for k in ref if k.startswith("blocks.")}


def test_pp_grads_match_unsharded(runs):
    """The pipelined backward: the loss's gradient counted once."""
    _check_grads([r["grads"] for r in runs[0]], runs[2]["grads_tgt"], 2)


def test_pp_composes_with_dp(runs):
    """('data', 'pipe') 2 x 2: each data rank's rows of every microbatch,
    the output and the gradients whole on every rank."""
    res = [r["dp"] for r in runs[1]]
    for y, _ in res:
        _close(y, runs[2]["fwd"], FWD_ATOL, "dp forward")
    # world rank = data * 2 + pipe: the stage is the minor coordinate
    per = DEPTH // 2
    for r, (_, g) in enumerate(res):
        for k, v in g.items():
            if k.startswith("blocks."):
                assert int(k.split(".")[1]) // per == r % 2, k
            want = runs[2]["grads_tgt_dp"][k]
            got = v if v is not None else torch.zeros_like(want)
            _close(got, want.numpy(), GRAD_ATOL, f"dp rank {r} {k}")


def test_pp_composes_with_tp(runs):
    """('pipe', 'model') 2 x 2: each stage's blocks Megatron-sharded over
    'model' (the stacked qkv leaf's rows, proj's columns halved), the
    forward and the gradients the unsharded module's."""
    res = [r["tp"] for r in runs[1]]
    for y, _ in res:
        _close(y, runs[2]["fwd"], FWD_ATOL, "tp forward")
    _check_grads(res, runs[2]["grads_tgt_tp"], 2, n_other=2)
    shapes = runs[1][0]["tp_shapes"]
    assert shapes["attn.qkv.weight"] == (1, 2, 3 * DIM // 2, DIM)
    assert shapes["attn.proj.weight"] == (1, 2, DIM, DIM // 2)
    assert shapes["mlp.fc1.weight"] == (1, 2, 2 * DIM, DIM)
    assert shapes["norm1.weight"] == (1, 2, DIM)


def test_pp_bf16_matches_unsharded(runs):
    """The pipelined bf16 TransHE against the unsharded one, atol 3e-2
    (JAX's pipelined-vs-unsharded bound); that unsharded port TransHE
    against JAX's bf16 one within tests/test_torch_bf16.py's TransHE bound,
    8 units of bf16's last place of the largest value."""
    _, _, tokens, pe = _inputs()
    net = TransHE(DIM, DEPTH, HEADS, compute_dtype=torch.bfloat16)
    net.load_state_dict(runs[3])
    with torch.no_grad():
        whole = net(torch.tensor(tokens), torch.tensor(pe)).float()
    for r in runs[0]:
        assert r["bf16"].dtype == torch.bfloat16
        _close(r["bf16"].float(), whole.numpy(), BF16_ATOL, "bf16")
    want = runs[2]["bf16"]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    _close(whole, want, 8 * ulp, "bf16 port vs JAX")


def test_pp_stage_params_hold_only_their_blocks(runs):
    """Stage s holds blocks s * 2 and s * 2 + 1 of the 4, and no other."""
    sd = runs[3]
    for s, r in enumerate(runs[0]):
        for leaf, t in r["stage_params"].items():
            assert t.shape[:2] == (1, 2), leaf
            for i in range(2):
                assert torch.equal(t[0, i], sd[f"blocks.{2 * s + i}.{leaf}"])


def test_pp_validation_errors(runs):
    """JAX's messages: depth vs stages, batch vs n_micro, a stacking for
    other stages, a tp_axis that is not a distinct mesh axis."""
    err = runs[0][0]["errors"]
    assert "depth 4 not divisible by n_stages 3" in err["stack"]
    assert "depth 3 not divisible by pipe axis 2" in err["depth"]
    assert "batch 4 not divisible by n_micro 3" in err["micro"]
    assert "params stacked for 4 stages" in err["stacked"]
    assert "not in mesh" in err["tp_missing"]
    assert "distinct axis" in err["tp_pipe"]


def test_stack_round_trip():
    from transhuman_tpu_torch.parallel import pp

    sd = port_sd(_inputs()[1])
    stacked = pp.stack_block_params(sd, 2)
    assert stacked["stages"]["attn.qkv.weight"].shape[:2] == (2, DEPTH // 2)
    back = pp.unstack_block_params(stacked)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_transhe_takes_centroids_and_a_mask_as_jax():
    """The port's TransHE: (B, C, 3) centroids embedded in it, a mask
    taking mask_token (set non-zero here), against JAX's TransHE."""
    model, params, tokens, pe = _inputs()
    params = jax.tree.map(np.asarray, params)
    params["mask_token"] = np.full((1, 1, DIM), 0.5, np.float32)
    mask = np.random.default_rng(1).random(tokens.shape[:2]) < 0.4
    want = model.apply({"params": params}, tokens, pe, jnp.asarray(mask))
    net = TransHE(DIM, DEPTH, HEADS)
    net.load_state_dict(port_sd(params))
    with torch.no_grad():
        got = net(torch.tensor(tokens), torch.tensor(pe),
                  torch.from_numpy(mask))
    _close(got, np.asarray(want), FWD_ATOL, "TransHE")
