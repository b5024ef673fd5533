"""The training slice: lamp_tpu_torch's make_train_step against
lamp_tpu's, on one tiny GPT.

A 2-block, 32-wide, 2-head LanguageModelModule (vocab 61, context 16) is
made by lamp_tpu from a seeded key and bridged into the port. Both train
20 steps with 2 accumulation micro-batches of 3 sequences, under the
reference example's optimizer (AdamW, beta2 0.95, global-norm clip 1.0,
weight decay 0.01 except on biases, norms, scales and embeddings) and
cosine_with_warmup, on the same numpy batches. The JAX step is jitted; the
port's runs eagerly on CPU through the flash_attention wrapper's plain
version.

Tolerance: in f32, per-step losses within rtol 1e-4 and final parameters
within atol 1e-4 (20 steps of f32 Adam updates of ~3e-3 each, from sums
taken in another order). In bf16 parameters with f32 masters, per-step
losses within rtol 2e-2 and final f32 masters within atol 5e-3: the two
frameworks round bf16 activations at different places, and Adam's
normalised update turns those differences into steps of the learning
rate's size. The key biases, whose true gradient is 0, are held in both
only to the bound of 20 such steps: Adam follows the rounding noise in
their gradients.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamp_tpu import nn as jnn
from lamp_tpu import optim as joptim
from lamp_tpu import train as jtrain
from lamp_tpu_torch import nn as tnn
from lamp_tpu_torch import optim as toptim
from lamp_tpu_torch import train as ttrain
from lamp_tpu_torch.optim import schedules as tsched

from .test_torch_modern import jax_params
from .test_torch_transformer import jax_lm, torch_lm

STEPS, ACCUM, BATCH, CTX, VOCAB = 20, 2, 3, 16, 61


def _decay(tag):
    # the reference example's tag-scoped weight decay
    return 0.0 if ("bias" in tag or "LayerNorm" in tag or "scale" in tag
                   or "Embedding" in tag) else 0.01


def _batches():
    rng = np.random.RandomState(0)
    for _ in range(STEPS):
        toks = rng.randint(0, VOCAB, (ACCUM, BATCH, CTX)).astype(np.int32)
        yield toks, np.roll(toks, -1, axis=2)


def _jax_run(jm):
    params = jnn.partition_params(jm)[0]
    opt = joptim.AdamW(3e-3, beta2=0.95, clip=1.0, weight_decay=_decay,
                       tags=jnn.param_tags(params))

    def loss_fn(m, batch, key, train):
        tokens, target = batch
        logits, nm = m.forward(tokens, key=key, train=train)
        return (jnn.lm_loss(logits, target),
                jnp.asarray(tokens.shape[0], jnp.float32), nm)

    state = jtrain.TrainState.init(jm, opt)
    step = jax.jit(jtrain.make_train_step(opt, loss_fn,
                                          accumulation_steps=ACCUM))
    sched = joptim.schedules.cosine_with_warmup(5, STEPS)
    key = jax.random.PRNGKey(1)
    losses = []
    for i, (toks, target) in enumerate(_batches()):
        _, factor = sched(None, i, None)
        state, (loss, _) = step(state, (jnp.asarray(toks),
                                        jnp.asarray(target)), key, factor)
        losses.append(float(loss))
    return losses, state


def _torch_run(tm):
    opt = toptim.AdamW(tm.named_parameters(), 3e-3, beta2=0.95, clip=1.0,
                       weight_decay=_decay, tags=tnn.param_tags(tm))

    def loss_fn(m, batch, generator, train):
        tokens, target = batch
        logits = m(tokens, train=train, generator=generator)
        return tnn.lm_loss(logits, target), tokens.shape[0]

    state = ttrain.TrainState.init(tm, opt)
    step = ttrain.make_train_step(opt, loss_fn, accumulation_steps=ACCUM)
    sched = tsched.cosine_with_warmup(5, STEPS)
    losses = []
    for i, (toks, target) in enumerate(_batches()):
        _, factor = sched(None, i, None)
        state, (loss, n) = step(state, (torch.tensor(toks).long(),
                                        torch.tensor(target).long()),
                                lr_factor=factor)
        assert n == ACCUM * BATCH
        losses.append(float(loss))
    assert state.step == STEPS and opt.param_groups[0]["step"] == STEPS
    return losses, state


def _atol(name, atol):
    # the key bias shifts every score of a row alike, so its true gradient
    # is 0 and Adam follows rounding noise in it with steps up to the
    # learning rate: it is held only to the bound of STEPS such steps
    return 3e-3 * STEPS if name.endswith("w_k.bias") else atol


def _linear_names(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, tnn.Linear)}


def test_train_steps_match_jax_f32():
    jm = jax_lm()
    tm = torch_lm(jm)
    want, jstate = _jax_run(jm)
    got, _ = _torch_run(tm)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    final = jax_params(jstate.params)
    linear = _linear_names(tm)
    for name, p in tm.named_parameters():
        w = final[name].T if name in linear else final[name]
        np.testing.assert_allclose(p.detach().numpy(), w,
                                   atol=_atol(name, 1e-4), rtol=0,
                                   err_msg=name)


def test_train_steps_match_jax_bf16_with_f32_masters():
    jm = jax_lm(dtype=jnp.bfloat16)
    tm = torch_lm(jm, dtype=torch.bfloat16)
    want, jstate = _jax_run(jm)
    got, tstate = _torch_run(tm)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    masters = jax_params(jstate.opt_state["master"])
    linear = _linear_names(tm)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        master = tstate.optimizer.state[p]["master"]
        assert master.dtype == torch.float32
        w = masters[name].T if name in linear else masters[name]
        np.testing.assert_allclose(master.numpy(), w, atol=_atol(name, 5e-3),
                                   rtol=0, err_msg=name)


def test_single_step_and_eval_step_match_jax():
    """No accumulation: the gradients stay in the parameters' dtype, as in
    the JAX step; then the eval step on the updated model."""
    jm = jax_lm(seed=2)
    tm = torch_lm(jm)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, VOCAB, (4, CTX)).astype(np.int32)
    target = np.roll(toks, -1, axis=1)

    def jloss(m, batch, key, train):
        logits, nm = m.forward(batch[0], key=key, train=train)
        return (jnn.lm_loss(logits, batch[1]),
                jnp.asarray(batch[0].shape[0], jnp.float32), nm)

    def tloss(m, batch, generator, train):
        return tnn.lm_loss(m(batch[0], train=train), batch[1]), \
            batch[0].shape[0]

    jopt = joptim.AdamW(1e-2)
    jstate = jtrain.TrainState.init(jm, jopt)
    jstate, (jl, _) = jtrain.make_train_step(jopt, jloss)(
        jstate, (jnp.asarray(toks), jnp.asarray(target)),
        jax.random.PRNGKey(0))
    topt = toptim.AdamW(tm.named_parameters(), 1e-2)
    tstate = ttrain.TrainState.init(tm, topt)
    batch = (torch.tensor(toks).long(), torch.tensor(target).long())
    tstate, (tl, n) = ttrain.make_train_step(topt, tloss)(tstate, batch)
    assert n == 4
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    je, _ = jtrain.make_eval_step(jloss)(
        jstate, (jnp.asarray(toks), jnp.asarray(target)))
    te, _ = ttrain.make_eval_step(tloss)(tstate, batch)
    assert not te.requires_grad
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)


def _regression():
    """A 5 -> 8 -> 3 tanh regression model (two lamp_tpu Linears, a tuple)
    and its port copy, with 6 rows of seeded features and targets."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jm = (jnn.Linear.init(5, 8, key=k1), jnn.Linear.init(8, 3, key=k2))
    tm = torch.nn.ModuleList([
        tnn.Linear(torch.tensor(np.asarray(lin.weight).T.copy()),
                   torch.tensor(np.asarray(lin.bias))) for lin in jm])
    rng = np.random.RandomState(8)
    x = rng.randn(6, 5).astype(np.float32)
    y = rng.randn(6, 3).astype(np.float32)
    return jm, tm, x, y


def _jax_mse(m, batch, key, train):
    x, y = batch
    out = m[1](jnp.tanh(m[0](x)))
    return jnp.mean((out - y) ** 2), jnp.float32(x.shape[0]), m


def _torch_mse(m, batch, generator, train):
    x, y = batch
    out = m[1](torch.tanh(m[0](x)))
    return torch.mean((out - y) ** 2), x.shape[0]


def test_adversarial_loss_calculation_matches_jax():
    """loss_calculation="adversarial" (the input moved along the sign of
    its gradient, the mean of the clean and the adversarial loss and
    gradients) on a small regression model: 3 AdamW steps in both packages,
    f32; losses within rtol 1e-5 and parameters within atol 1e-5."""
    jm, tm, x, y = _regression()
    jopt = joptim.AdamW(1e-2)
    jstate = jtrain.TrainState.init(jm, jopt)
    jstep = jax.jit(jtrain.make_train_step(
        jopt, _jax_mse, loss_calculation="adversarial", adversarial_eps=0.1))
    topt = toptim.AdamW(tm.named_parameters(), 1e-2)
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(topt, _torch_mse,
                                   loss_calculation="adversarial",
                                   adversarial_eps=0.1)
    for i in range(3):
        batch = (x + i, y)
        jstate, (jl, _) = jstep(jstate, tuple(map(jnp.asarray, batch)),
                                jax.random.PRNGKey(0))
        tstate, (tl, n) = tstep(tstate, tuple(map(torch.from_numpy, batch)))
        assert n == 6
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for lin, jlin in zip(tm, jstate.params):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(jlin.weight).T, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(jlin.bias), atol=1e-5)
    # the adversarial half's loss is above the clean loss it is averaged
    # with
    batch = (torch.from_numpy(x + 3), torch.from_numpy(y))
    with torch.no_grad():
        clean = float(_torch_mse(tm, batch, None, False)[0])
    assert float(tstep(tstate, batch)[1][0]) > clean


def test_perturbed_loss_calculation():
    """loss_calculation="perturbed" takes the gradient at parameters moved
    by adversarial_eps times a normal draw of the step's generator, then
    updates the clean parameters with it. The port's noise is its own
    draw, so the JAX side is built by hand with the same draw: the noise
    of a generator of the same seed, in the port's parameter order
    (transposed to JAX's [in, out] layout), added to the JAX parameters,
    the gradient of the loss there, JAX's AdamW applied to the clean
    parameters. 3 steps from one generator, f32: losses within rtol 1e-5
    and parameters within atol 1e-5. At eps 0 the step is "simple"'s bit
    for bit."""
    eps = 0.5
    jm, tm, x, y = _regression()
    jopt = joptim.AdamW(1e-2)
    jparams, _ = jnn.partition_params(jm)
    jopt_state = jopt.init(jparams)
    treedef = jax.tree_util.tree_structure(jparams)
    names = [name for name, _ in tm.named_parameters()]
    assert names == ["0.weight", "0.bias", "1.weight", "1.bias"]
    model = copy.deepcopy(tm)
    topt = toptim.AdamW(model.named_parameters(), 1e-2)
    tstate = ttrain.TrainState.init(model, topt)
    tstep = ttrain.make_train_step(topt, _torch_mse,
                                   loss_calculation="perturbed",
                                   adversarial_eps=eps)
    tgen, ref_gen = (torch.Generator().manual_seed(1),
                     torch.Generator().manual_seed(1))

    def jax_loss(params, batch):
        return _jax_mse(params, batch, None, True)[0]

    for i in range(3):
        batch = (x + i, y)
        noise = [torch.randn(p.shape, generator=ref_gen, dtype=p.dtype)
                 .mul_(eps).numpy() for p in model.parameters()]
        noise = [n.T if n.ndim == 2 else n for n in noise]
        leaves = jax.tree_util.tree_leaves(jparams)
        assert [n.shape for n in noise] == [leaf.shape for leaf in leaves]
        noisy = jax.tree_util.tree_unflatten(
            treedef, [leaf + n for leaf, n in zip(leaves, noise)])
        jl, grads = jax.value_and_grad(jax_loss)(
            noisy, tuple(map(jnp.asarray, batch)))
        jparams, jopt_state = jopt.step(jparams, grads, jopt_state)
        tstate, (tl, n) = tstep(tstate, tuple(map(torch.from_numpy, batch)),
                                tgen)
        assert n == 6
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for lin, jlin in zip(model, jparams):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(jlin.weight).T, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(jlin.bias), atol=1e-5)

    batch = (torch.from_numpy(x), torch.from_numpy(y))
    runs = []
    for kind, eps in (("simple", 1e-3), ("perturbed", 0.0)):
        model = copy.deepcopy(tm)
        opt = toptim.AdamW(model.named_parameters(), 1e-2)
        step = ttrain.make_train_step(opt, _torch_mse, loss_calculation=kind,
                                      adversarial_eps=eps)
        state = ttrain.TrainState.init(model, opt)
        losses = [float(step(state, batch,
                             torch.Generator().manual_seed(1))[1][0])
                  for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert l1 == l0 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(ValueError, match="generator"):
        ttrain.make_train_step(toptim.AdamW(tm.named_parameters()),
                               _torch_mse, loss_calculation="perturbed")(
            ttrain.TrainState.init(tm, None), batch)
    with pytest.raises(ValueError):
        ttrain.make_train_step(None, None, loss_calculation="other")


def _packed_batches(steps, rows=3, ctx=16):
    """Rows of packed documents (3-11 tokens) for each step, from numpy:
    (tokens, targets, segment_ids, positions), int32 [rows, ctx] each."""
    from lamp_tpu_torch.data import pack_documents

    rng = np.random.RandomState(6)
    for _ in range(steps):
        docs = [rng.randint(0, VOCAB, rng.randint(3, 12)) for _ in range(12)]
        p = pack_documents(docs, ctx)
        yield tuple(p[k][:rows] for k in ("tokens", "targets", "segment_ids",
                                          "positions"))


def _jax_packed_step(opt):
    def loss_fn(m, batch, key, train):
        tokens, targets, seg, pos = batch
        loss = m.loss(tokens, targets, segment_ids=seg, positions=pos)
        return loss, jnp.sum(targets != -100).astype(jnp.float32), m

    return jax.jit(jtrain.make_train_step(opt, loss_fn))


def test_packed_modern_lm_train_steps_match_jax_f32():
    """Packed-document ModernLM training: a 2-block, 64-wide ModernLM
    (GQA 4/2 heads, vocab 61, context 16) bridged from lamp_tpu takes 20
    AdamW steps on the same packed rows in both packages (f32, through
    ModernLM.loss and the fused cross-entropy); per-step losses within
    rtol 1e-4, as test_train_steps_match_jax_f32."""
    from .test_torch_modern import jax_modern_lm

    jm = jax_modern_lm(context_length=16)
    tm = tnn_load(jm)
    jopt = joptim.AdamW(3e-3, weight_decay=0.01)
    jstep = _jax_packed_step(jopt)
    jstate = jtrain.TrainState.init(jm, jopt)
    topt = toptim.AdamW(tm.named_parameters(), 3e-3, weight_decay=0.01)
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(topt, ttrain.packed_lm_loss)
    key = jax.random.PRNGKey(0)
    want, got = [], []
    for batch in _packed_batches(STEPS):
        jstate, (jl, _) = jstep(jstate, tuple(map(jnp.asarray, batch)), key)
        tstate, (tl, n) = tstep(tstate, tuple(torch.from_numpy(x).long()
                                              for x in batch))
        assert n == int((batch[1] != -100).sum())
        want.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _plain_causal_train_losses(jm, vocab, ctx):
    """20 AdamW steps (3e-4, weight decay 0.01) of the JAX ModernLM ``jm``
    and its bridged copy on the same plain causal rows (2 of ``ctx``
    seeded tokens a step, no segment ids), f32, through ModernLM.loss:
    the per-step losses (port, JAX)."""
    tm = tnn_load(jm)

    def jloss(m, batch, key, train):
        return m.loss(batch[0], batch[1]), jnp.float32(batch[1].size), m

    jopt = joptim.AdamW(3e-4, weight_decay=0.01)
    jstep = jax.jit(jtrain.make_train_step(jopt, jloss))
    jstate = jtrain.TrainState.init(jm, jopt)
    topt = toptim.AdamW(tm.named_parameters(), 3e-4, weight_decay=0.01)
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(
        topt, lambda m, b, generator, train: (m.loss(b[0], b[1]),
                                              b[1].numel()))
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(11)
    want, got = [], []
    for _ in range(STEPS):
        rows = rng.randint(0, vocab, (2, ctx + 1)).astype(np.int32)
        batch = (rows[:, :-1], rows[:, 1:])
        jstate, (jl, _) = jstep(jstate, tuple(map(jnp.asarray, batch)), key)
        tstate, (tl, _) = tstep(tstate, tuple(torch.from_numpy(x).long()
                                              for x in batch))
        want.append(float(jl))
        got.append(float(tl))
    return got, want


def test_gemma_width_modern_lm_train_steps_match_jax_f32():
    """A ModernLM at Gemma-2B's proportions, scaled down (chip_smoke.py's
    phase 12 trains the full widths on the card): 2 blocks, 512 wide, 2
    query heads over 1 kv head (head_dim 256), SwiGLU 1024, vocab 97,
    context 80, tied, bridged from lamp_tpu. 20 AdamW steps on the same
    plain causal rows (2 of 80 seeded tokens a step, no segment ids) in
    both packages, f32, through ModernLM.loss; per-step losses within rtol
    1e-4, as test_train_steps_match_jax_f32."""
    from .test_torch_modern import jax_modern_lm

    ctx, vocab = 80, 97
    jm = jax_modern_lm(vocab_size=vocab, context_length=ctx, num_blocks=2,
                       embed_dim=512, num_heads=2, num_kv_heads=1,
                       mlp_hidden=1024, tied=True, norm_eps=1e-6,
                       rope_base=10000.0)
    tm = tnn_load(jm)
    assert tm.blocks[0].num_kv_heads == 1 and tm.rope_cos.shape[-1] == 128
    got, want = _plain_causal_train_losses(jm, vocab, ctx)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_openllama_width_modern_lm_train_steps_match_jax_f32():
    """A ModernLM at OpenLLaMA-3B's proportions, scaled down (chip_smoke.py's
    phase 13 trains the full widths on the card): 2 blocks, 400 wide, 4
    query heads over 4 kv heads (head_dim 100, not a multiple of 8: the
    ragged kernels on the card), SwiGLU 1080, vocab 97, context 80,
    untied, bridged from lamp_tpu. 20 AdamW steps on the same plain
    causal rows in both packages, f32, through ModernLM.loss; per-step
    losses within rtol 1e-4, as test_train_steps_match_jax_f32."""
    from .test_torch_modern import jax_modern_lm

    ctx, vocab = 80, 97
    jm = jax_modern_lm(vocab_size=vocab, context_length=ctx, num_blocks=2,
                       embed_dim=400, num_heads=4, num_kv_heads=4,
                       mlp_hidden=1080, tied=False, norm_eps=1e-6,
                       rope_base=10000.0)
    tm = tnn_load(jm)
    assert tm.blocks[0].num_kv_heads == 4 and tm.rope_cos.shape[-1] == 50
    assert tm.lm_head is not None
    got, want = _plain_causal_train_losses(jm, vocab, ctx)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_packed_modern_lm_resumes_from_jax_state():
    """The JAX ModernLM and its AdamW state after 3 packed steps, carried
    across by the bridge (load_modern_lm, load_adamw_state): the next 3
    steps' losses agree within rtol 1e-4."""
    from lamp_tpu_torch import bridge

    from .test_torch_modern import jax_modern_lm

    jopt = joptim.AdamW(3e-3, weight_decay=0.01)
    jstep = _jax_packed_step(jopt)
    key = jax.random.PRNGKey(0)
    jstate = jtrain.TrainState.init(jax_modern_lm(seed=3, context_length=16),
                                    jopt)
    batches = list(_packed_batches(6))
    for batch in batches[:3]:
        jstate, _ = jstep(jstate, tuple(map(jnp.asarray, batch)), key)
    tm = tnn_load(jstate.model)
    topt = toptim.AdamW(tm.named_parameters(), 3e-3, weight_decay=0.01)
    os_ = jstate.opt_state
    bridge.load_adamw_state(
        {"step": int(os_["step"]), "mt": jax_params(os_["mt"]),
         "vt": jax_params(os_["vt"]), "master": {}}, topt, tm)
    tstate = ttrain.TrainState.init(tm, topt)
    tstep = ttrain.make_train_step(topt, ttrain.packed_lm_loss)
    for batch in batches[3:]:
        jstate, (jl, _) = jstep(jstate, tuple(map(jnp.asarray, batch)), key)
        tstate, (tl, _) = tstep(tstate, tuple(torch.from_numpy(x).long()
                                              for x in batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)


def tnn_load(jm):
    from lamp_tpu_torch.bridge import load_modern_lm

    return load_modern_lm(jax_params(jm), device="cpu")
