"""The port's transformer against the JAX package's, at a tiny f32 size.

The JAX parameters are carried across with ``params_from_jax``; logits and
one full training step (forward, loss, backward, AdamW) are compared. The
JAX side runs its Pallas flash kernel in interpreter mode (on the CPU its
model does so by itself); the port runs the plain versions of its kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.models import transformer as jt
from torchsnapshot_tpu_torch.models import transformer as tt

# One intra-op thread: the suite runs this file beside others in parallel
# workers, and torch's default of a thread per core would starve them (and
# their timing-sensitive tests).
torch.set_num_threads(1)

# f32 on both sides, same parameters and tokens: the programs differ only in
# summation order inside matmuls, softmax and the norms (XLA against torch
# CPU kernels). 1e-5 holds for logits of size ~1 and for the loss; after one
# AdamW step each parameter moved by ~lr = 1e-3 and agrees to 1e-5.
TOL = 1e-5


def _cfgs(attn_impl: str = "flash"):
    kw = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256)
    return (
        jt.TransformerConfig(**kw, dtype=jnp.float32, attn_impl=attn_impl),
        tt.TransformerConfig(**kw, dtype=torch.float32, attn_impl=attn_impl),
    )


def _tokens(cfg, batch: int = 2, seq: int = 128) -> np.ndarray:
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _port_state(jcfg, tcfg, jstate) -> tt.TrainState:
    state = tt.init_train_state(tcfg, seed=1, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state.model.load_state_dict(tt.params_from_jax(tcfg, params))
    return state


def test_params_tree_matches_jax_names_and_shapes() -> None:
    jcfg, tcfg = _cfgs()
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tt.params_tree(tt.Transformer(tcfg, device="cpu"))
    j_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    t_leaves = jax.tree_util.tree_flatten_with_path(tparams)[0]
    assert [(p, tuple(a.shape)) for p, a in j_leaves] == [
        (p, tuple(t.shape)) for p, t in t_leaves
    ]


@pytest.mark.parametrize("attn_impl", ["flash", "ulysses"])
def test_logits_match_jax_forward(attn_impl) -> None:
    jcfg, tcfg = _cfgs(attn_impl)
    jstate = jt.init_train_state(jcfg, seed=0)
    tokens = _tokens(jcfg)
    want = jt.forward(jcfg, jstate.params, jnp.asarray(tokens))
    state = _port_state(jcfg, tcfg, jstate)
    with torch.no_grad():
        got = state.model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _step_both(optimizer=None):
    """One training step on each side from the same parameters and tokens.
    ``optimizer`` builds a replacement for the port's AdamW (a planted
    fault)."""
    jcfg, tcfg = _cfgs()
    jstate = jt.init_train_state(jcfg, seed=0)
    tokens = _tokens(jcfg)
    state = _port_state(jcfg, tcfg, jstate)
    if optimizer is not None:
        state.optimizer = optimizer(state.model.parameters(), tcfg.learning_rate)
    before = {n: p.detach().clone().numpy() for n, p in state.model.named_parameters()}
    jstate, jloss = jt.make_train_step(jcfg)(jstate, jnp.asarray(tokens))
    state, loss = tt.make_train_step(tcfg)(state, torch.from_numpy(tokens).long())
    return tcfg, before, jstate, jloss, state, loss


def _assert_step_matches(tcfg, before, jstate, jloss, state, loss) -> None:
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert state.step == int(jstate.step) == 1

    # The same keys on both sides: JAX's trees through params_from_jax.
    as_sd = lambda tree: tt.params_from_jax(  # noqa: E731
        tcfg, jax.tree_util.tree_map(np.asarray, tree)
    )
    adam = jstate.opt_state[0]
    want_p, want_mu, want_nu = as_sd(jstate.params), as_sd(adam.mu), as_sd(adam.nu)
    live = dict(state.model.named_parameters())
    assert sorted(live) == sorted(want_p)
    for name, p in live.items():
        st = state.optimizer.state[p]
        # After one step mu = 0.1 g and nu = 1e-3 g^2: both are held to
        # MOMENT_RTOL of each element and, for elements where g is near 0
        # (where the two programs' gradients differ in their last bits),
        # to MOMENT_RTOL of the leaf's largest value.
        for got, want in ((st["exp_avg"], want_mu[name]), (st["exp_avg_sq"], want_nu[name])):
            want = want.numpy()
            np.testing.assert_allclose(
                got.numpy(), want, rtol=MOMENT_RTOL,
                atol=MOMENT_RTOL * float(np.abs(want).max()), err_msg=name,
            )
        # The parameter change, not the parameter: decay moves p by only
        # lr * wd * |p| (~1e-7 |p|), under any tolerance on p itself.
        # Adam's first update is lr * g / (|g| + eps): where |g| is within
        # a few hundred eps of zero (but not 0) the quotient amplifies the
        # last-bit difference of g between the two programs, so those
        # elements are held only to Adam's bound on one step (|update| <=
        # lr + decay). Everywhere else the change is held to DELTA_RTOL of
        # itself plus two f32 ulps of p (the rounding of p + change).
        p0 = before[name]
        got_d = p.detach().numpy() - p0
        want_d = want_p[name].numpy() - p0
        g = np.abs(want_mu[name].numpy()) / 0.1
        sharp = (g > 1e-6) | (g == 0)
        err = np.abs(got_d - want_d)
        bound = DELTA_RTOL * np.abs(want_d) + 2 * np.spacing(np.abs(p0))
        assert np.all(err[sharp] <= bound[sharp]), (name, float((err - bound)[sharp].max()))
        assert np.all(err[~sharp] <= 2 * tcfg.learning_rate), name
        assert sharp.mean() > 0.5, name  # the sharp check covers most of the tensor


# Elementwise tolerance of the moments and the parameter change. The
# gradients agree to ~1e-6 relative (f32, other summation orders); 1e-4
# leaves room for that and still sees a tenfold nu (betas (0.9, 0.99)) or
# lr * 1e-2 * |p| of extra decay.
MOMENT_RTOL = 1e-4
DELTA_RTOL = 1e-4


def test_train_step_matches_jax() -> None:
    _assert_step_matches(*_step_both())


@pytest.mark.parametrize(
    "fault",
    [
        # torch's default AdamW decay (1e-2) where optax.adamw uses 1e-4
        lambda params, lr: torch.optim.AdamW(params, lr=lr),
        # beta2 0.99 where optax.adamw uses 0.999: nu is 10x too large
        lambda params, lr: torch.optim.AdamW(
            params, lr=lr, betas=(0.9, 0.99), weight_decay=1e-4
        ),
    ],
    ids=["default_weight_decay", "beta2"],
)
def test_train_step_check_sees_a_misconfigured_adamw(fault) -> None:
    """The step comparison above fails on an AdamW that differs from
    optax.adamw's settings in one constant."""
    with pytest.raises(AssertionError):
        _assert_step_matches(*_step_both(fault))


def test_flash_needs_seq_multiple_of_128() -> None:
    _, tcfg = _cfgs()
    model = tt.Transformer(tcfg, device="cpu")
    with pytest.raises(ValueError, match="seq % 128"):
        model(torch.zeros((1, 96), dtype=torch.long))


def test_train_step_advances_the_train_rng() -> None:
    _, tcfg = _cfgs()
    state = tt.init_train_state(tcfg, seed=0, device="cpu")
    before = state.rng.get_state().clone()
    tt.make_train_step(tcfg)(state, torch.from_numpy(_tokens(tcfg)).long())
    assert not torch.equal(before, state.rng.get_state())
