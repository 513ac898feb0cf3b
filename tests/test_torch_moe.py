"""The port's MoE blocks against the JAX package's, at a tiny f32 size.

Every ``moe_every``-th block is a soft-routed MoE block (a router and
expert-stacked ``w_in`` / ``w_out``). Held here: the ``Params`` tree's
names and shapes against ``init_params``; ``_moe_mlp`` alone on numpy
inputs; logits with flash (the JAX Pallas kernel in interpreter mode, the
port's plain version on the CPU) and with the dense attention; one full
training step (loss, moments, parameter change, as
``test_torch_model._assert_step_matches`` holds them); and
``params_from_jax`` of an MoE tree. Tolerances are those of
``tests/test_torch_model.py`` (f32 on both sides: the programs differ only
in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.models import transformer as jt
from torchsnapshot_tpu_torch.models import transformer as tt

from test_torch_model import TOL, _assert_step_matches

torch.set_num_threads(1)


def _cfgs(attn_impl: str = "flash", n_experts: int = 4, moe_every: int = 2, n_layers: int = 4):
    kw = dict(
        vocab_size=256, d_model=64, n_heads=4, n_layers=n_layers, d_ff=128,
        n_experts=n_experts, moe_every=moe_every,
    )
    return (
        jt.TransformerConfig(**kw, dtype=jnp.float32, attn_impl=attn_impl),
        tt.TransformerConfig(**kw, dtype=torch.float32, attn_impl=attn_impl),
    )


def _tokens(cfg, batch: int = 2, seq: int = 128) -> np.ndarray:
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(tcfg, jparams) -> tt.TrainState:
    state = tt.init_train_state(tcfg, seed=1, device="cpu")
    state.model.load_state_dict(tt.params_from_jax(tcfg, _numpy(jparams)))
    return state


@pytest.mark.parametrize("n_experts,moe_every", [(4, 2), (2, 1), (4, 3)])
def test_moe_params_tree_matches_jax_names_and_shapes(n_experts, moe_every) -> None:
    jcfg, tcfg = _cfgs(n_experts=n_experts, moe_every=moe_every)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = tt.Transformer(tcfg, device="cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    t_leaves = jax.tree_util.tree_flatten_with_path(tt.params_tree(model))[0]
    assert [(p, tuple(a.shape)) for p, a in j_leaves] == [(p, tuple(t.shape)) for p, t in t_leaves]
    moe = [i for i in range(tcfg.n_layers) if tt.is_moe_layer(tcfg, i)]
    assert moe == [i for i, blk in enumerate(jparams["layers"]) if "router" in blk]
    for i in moe:
        assert tuple(model.layers[i].w_in.shape) == (n_experts, 64, 128)
        assert tuple(model.layers[i].w_out.shape) == (n_experts, 128, 64)


def test_moe_mlp_matches_jax() -> None:
    """``_moe_mlp`` alone, on numpy activations and a JAX-initialized MoE
    block."""
    jcfg, tcfg = _cfgs()
    block = _numpy(jt.init_params(jcfg, jax.random.PRNGKey(3))["layers"][1])
    assert "router" in block
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(np.float32)
    want = np.asarray(jt._moe_mlp({k: jnp.asarray(v) for k, v in block.items()}, jnp.asarray(x)))
    got = tt._moe_mlp({k: torch.from_numpy(np.array(v)) for k, v in block.items()}, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_impl", ["flash", "ulysses"])
def test_moe_logits_match_jax_forward(attn_impl) -> None:
    jcfg, tcfg = _cfgs(attn_impl)
    jstate = jt.init_train_state(jcfg, seed=0)
    tokens = _tokens(jcfg)
    want = jt.forward(jcfg, jstate.params, jnp.asarray(tokens))
    state = _port_state(tcfg, jstate.params)
    with torch.no_grad():
        got = state.model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_moe_train_step_matches_jax() -> None:
    """One step from the same parameters and tokens: the loss, both AdamW
    moments of every leaf (the router and the expert stacks included) and
    every parameter's change."""
    jcfg, tcfg = _cfgs()
    jstate = jt.init_train_state(jcfg, seed=0)
    tokens = _tokens(jcfg)
    state = _port_state(tcfg, jstate.params)
    before = {n: p.detach().clone().numpy() for n, p in state.model.named_parameters()}
    assert any(n.endswith("router") for n in before)
    jstate, jloss = jt.make_train_step(jcfg)(jstate, jnp.asarray(tokens))
    state, loss = tt.make_train_step(tcfg)(state, torch.from_numpy(tokens).long())
    _assert_step_matches(tcfg, before, jstate, jloss, state, loss)


def test_params_from_jax_carries_the_moe_tree_bit_for_bit() -> None:
    jcfg, tcfg = _cfgs()
    jparams = _numpy(jt.init_params(jcfg, jax.random.PRNGKey(5)))
    sd = tt.params_from_jax(tcfg, jparams)
    model = tt.Transformer(tcfg, device="cpu")
    assert sorted(sd) == sorted(n for n, _ in model.named_parameters())
    model.load_state_dict(sd)
    got = jax.tree_util.tree_flatten_with_path(tt.params_tree(model))[0]
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for (path, t), (_, a) in zip(got, want):
        assert t.detach().numpy().tobytes() == a.tobytes(), path


def test_moe_config_refuses_bad_values() -> None:
    for kw in ({"n_experts": -1}, {"moe_every": 0}):
        with pytest.raises(ValueError, match="n_experts >= 0 and moe_every >= 1"):
            tt.Transformer(tt.TransformerConfig(vocab_size=8, d_model=8, n_heads=2, n_layers=1, d_ff=8, **kw), device="cpu")
