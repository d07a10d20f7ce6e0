"""bf16 training: prosim_torch's `ProSim(config, device, dtype=torch.bfloat16)`
through `make_train_step` against jax.value_and_grad of the JAX package's
bf16 train loss (`ProSim(config, jnp.bfloat16)`, as `bench.py --mode train`
builds it) and optax, on the CPU, for configs/no_text.yaml and
configs/with_text.yaml (the tiny() Llama).

Parameters, gradients and AdamW's moments stay f32 in both packages; the
network body computes in bf16. bf16 cannot be held to the f32 bars, so each
comparison uses tests/test_torch_bf16.py's 2x rule:

    max |port_bf16 - jax_f32| <= 2 * max |jax_bf16 - jax_f32| + atol

where jax_f32 is the JAX package in f32 on the same inputs and weights and
jax_bf16 its bf16 program, compiled with XLA's excess precision off
(`xla_allow_excess_precision`), so each bf16 operation rounds once as the
program states it. The atols: LOSS_ATOL one bf16 ulp (2**-8) of the f32
loss term (or of 1 where a term is below 1), GRAD_ATOL 1e-3 of each leaf's largest f32
gradient, PARAM_ATOL 1e-6 absolute on the parameters (the configs' LR is
3e-4, so a step that took the wrong sign is off by 6e-4).

Gradients are held at one replan step (R = 1): at R >= 2 the closed loop's
gradient is ill-conditioned (ROADMAP.md C). The losses are held at R = 2
too. Dropout is 0 where the packages are compared (their RNG streams cannot
match); the remat and resume cases run at the configs' dropout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models import decoder as jdecoder
from prosim_tpu.models import policy as jpolicy
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.ops import attention as jattn
from prosim_tpu.train import losses as jlosses
from prosim_tpu.train import optim as joptim
from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.prosim import ProSim
from prosim_torch.train import losses as tlosses
from prosim_torch.train import optim as toptim
from prosim_torch.train.train_step import make_train_step
from prosim_torch.train.trainer import Trainer, find_latest_checkpoint
from prosim_torch.utils.params import flax_to_state_dict, init_params, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_OPTS = [  # tests/test_torch_train.py's widths
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2",
    "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
]
TEXT_OPTS = [  # tests/test_torch_text_train.py's
    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS", "32",
    "MODEL.CONDITION_TRANSFORMER.NLAYER", "1",
]
NO_DROPOUT = [
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0",
    "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
]
CONFIGS = {"no_text": ("configs/no_text.yaml", SMALL_OPTS),
           "with_text": ("configs/with_text.yaml", SMALL_OPTS + TEXT_OPTS)}
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6)
STEP_OPTS = ["TRAIN.SCHEDULER.WARMUP_STEPS", "0",  # both steps at the full LR
             "TRAIN.GRAD_CLIP", "0.0"]
LOSS_ATOL = 2.0 ** -8  # of the f32 loss: one bf16 ulp
GRAD_ATOL = 1e-3   # of the leaf's largest f32 gradient
PARAM_ATOL = 1e-6  # absolute
LORA_LEAVES = ("lora_b", "lora_embed_b")  # zero at init; perturbed so every LoRA leaf trains


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _compile(bits, fn, *args):
    """jit fn for args; the bf16 programs round every operation."""
    opts = {} if bits == 32 else {"xla_allow_excess_precision": False}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _perturb_lora(params, scale=0.05):
    def leaf(path, x):
        if str(getattr(path[-1], "key", path[-1])) in LORA_LEAVES:
            return np.asarray(jax.random.normal(jax.random.PRNGKey(x.size), x.shape)) * scale
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def _two_x(got, ref16, ref32, atol, what):
    got, ref16, ref32 = (np.asarray(a, np.float64) for a in (got, ref16, ref32))
    assert np.isfinite(got).all(), what
    err_port, err_jax = np.abs(got - ref32).max(), np.abs(ref16 - ref32).max()
    assert err_port <= 2 * err_jax + atol, (what, err_port, err_jax)
    return err_port, err_jax


def _site_gather_unpacked(x_src, src_pos, src_ori, idx):
    """prosim_tpu.ops.attention.site_gather without its bf16 bit-packing:
    the bf16 rows ride in the gathered f32 table as f32 values, not as
    bitcast words. The same values come out (bf16 -> f32 -> bf16 is
    exact), and, unlike the bitcast, the gather has a gradient."""
    feats = jattn._norm_stats(x_src)
    D = feats.shape[-1]
    table = jnp.concatenate([feats.astype(jnp.float32), src_pos.astype(jnp.float32),
                             src_ori[..., None].astype(jnp.float32)], axis=-1)
    g = jattn.gather_neighbors(table, idx)
    return jax.lax.optimization_barrier((g[..., :D].astype(x_src.dtype), g[..., D:D + 2],
                                         g[..., D + 2]))


def _noisy(params, draw):
    """params times 1 + 2**-9 noise: half a bf16 ulp, about one rounding of
    each bf16 weight."""
    return jax.tree.map(lambda x: x * (1 + 2.0 ** -9 * np.asarray(jax.random.normal(
        jax.random.PRNGKey(1000 * draw + x.size), x.shape))), params)


class Side:
    """One configuration: the JAX models in f32 and bf16 on one flax param
    tree, each package's batch from one seed, the JAX train loss and its
    gradients, and the JAX package's optimizer.

    Two oracle changes, each a fault or a stated divergence of the frozen
    JAX package (ROADMAP.md C): the frozen Llama body's gradients are
    zeroed before the optimizer (the port freezes the body, as
    tests/test_torch_text_train.py's oracle does); and the decoder and
    policy gather their bf16 source rows through _site_gather_unpacked,
    because the JAX package's bit-packed bf16 gather has no gradient, so
    its bf16 train step leaves the scene encoder without one
    (test_jax_bf16_site_gather_cuts_the_gradient)."""

    def __init__(self, name):
        yaml, opts = CONFIGS[name]
        path = os.path.join(REPO, yaml)
        opts = opts + NO_DROPOUT + STEP_OPTS
        self.name = name
        self.jcfg, self.tcfg = jax_get_config(path, opts), get_config(path, opts)
        self.jb = {r: jax_synthetic(self.jcfg, seed=0, num_replan=r, **BATCH_KW) for r in (1, 2)}
        self.tb = {r: make_synthetic_batch(self.tcfg, seed=0, device="cpu", num_replan=r,
                                           **BATCH_KW) for r in (1, 2)}
        params = _host(JaxProSim(self.jcfg).init(jax.random.PRNGKey(0), self.jb[1]))
        self.params = _perturb_lora(params) if name == "with_text" else params
        self.labels = jax.tree_util.tree_map_with_path(
            lambda p, _: joptim._group_of("/".join(str(getattr(k, "key", k)) for k in p),
                                          self.jcfg), self.params)
        self.key = jax.random.PRNGKey(1)
        self.vg, self.loss, self.terms2 = {}, {}, {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdecoder, "site_gather", _site_gather_unpacked)
            mp.setattr(jpolicy, "site_gather", _site_gather_unpacked)
            for bits, dt in ((32, jnp.float32), (16, jnp.bfloat16)):
                jm = JaxProSim(self.jcfg, dt)
                impl = jlosses.loss_func_dict[self.jcfg.TASK.MOTION_PRED.LOSS]

                def loss_fn(p, b, k, jm=jm, impl=impl):  # the JAX make_train_step's
                    terms = impl(b, jm.forward(p, b, "train", k), self.jcfg)
                    return terms["full_loss"] * self.jcfg.TASK.MOTION_PRED.WEIGHT, terms

                vg = jax.value_and_grad(loss_fn, has_aux=True)
                self.vg[bits] = _compile(bits, vg, self.params, self.jb[1], self.key)
                self.loss[bits] = _compile(bits, loss_fn, self.params, self.jb[2], self.key)
                out2 = self.loss[bits](self.params, self.jb[2], self.key)
                self.terms2[bits] = _host(out2[1])
                if bits == 16:  # the bf16 terms' dtypes at R = 2 and R = 1
                    self.dtypes = {2: jax.tree.map(lambda a: jnp.dtype(a.dtype), out2[1]),
                                   1: jax.tree.map(lambda a: jnp.dtype(a.dtype), jax.eval_shape(
                                       loss_fn, self.params, self.jb[1], self.key)[1])}
        self._own16, self._own_terms = {}, None

    def _frozen_zeroed(self, grads):
        return jax.tree.map(lambda g, lab: jnp.zeros_like(g) if lab == "llm_frozen" else g,
                            grads, self.labels)

    def grads(self, bits, params):
        """The JAX train loss, its terms and its gradients (the frozen body's
        zeroed) at a flax param tree, the gradients also by port name."""
        (loss, terms), g = self.vg[bits](params, self.jb[1], self.key)
        g = _host(self._frozen_zeroed(g))
        return float(loss), _host(terms), g, flax_to_state_dict(g)

    def own16(self, params, draws=2):
        """Per leaf, the largest movement of the JAX bf16 gradient at
        `params` when the weights take _noisy's rounding-sized change, over
        `draws` draws."""
        key = id(params)
        if key not in self._own16:
            g0 = self.grads(16, params)[3]
            own = {n: 0.0 for n in g0}
            for d in range(draws):
                g = self.grads(16, _noisy(params, d))[3]
                for n in own:
                    own[n] = max(own[n], float(np.abs(g[n] - g0[n]).max()))
            self._own16[key] = (params, own)  # params kept so its id stays unique
        return self._own16[key][1]

    def grad_bar(self, params, g32, g16, n):
        """The bound a port gradient leaf n at `params` is held to: twice the
        larger of the JAX bf16 gradient's distance from the f32 one and its
        own movement (own16), plus GRAD_ATOL of the leaf's largest f32
        gradient."""
        return (2 * max(np.abs(g16[n] - g32[n]).max(), self.own16(params)[n])
                + GRAD_ATOL * np.abs(g32[n]).max())

    def from_state_dict(self, sd):
        """A {port name: array} dict as a flax tree in self.params' layout:
        flax_to_state_dict inverted through a tree of unique element ids (it
        only transposes and renames)."""
        count = [0]

        def ids(x):
            count[0] += x.size
            return np.arange(count[0] - x.size, count[0]).reshape(x.shape)

        index = jax.tree.map(ids, self.params)
        values = np.empty(count[0], np.float32)
        for n, w in flax_to_state_dict(index).items():
            values[w.reshape(-1)] = np.asarray(sd[n], np.float32).reshape(-1)
        return jax.tree.map(lambda i, x: values[i].astype(x.dtype), index, self.params)

    def to_flax(self, model):
        """The port model's parameters as a flax tree."""
        return self.from_state_dict({n: t.float().numpy() for n, t in model.state_dict().items()})

    def own_terms(self, draws=2):
        """{R: {term: its largest movement}} of the JAX bf16 loss terms under
        _noisy's change of the weights, at R = 1 and 2."""
        if self._own_terms is None:
            ref = {1: self.grads(16, self.params)[1], 2: self.terms2[16]}
            own = {r: {k: 0.0 for k in ref[r]} for r in ref}
            for d in range(draws):
                noisy = _noisy(self.params, d)
                got = {1: _host(self.vg[16](noisy, self.jb[1], self.key)[0][1]),
                       2: _host(self.loss[16](noisy, self.jb[2], self.key)[1])}
                for r in own:
                    for k in own[r]:
                        own[r][k] = max(own[r][k], float(np.abs(got[r][k] - ref[r][k])))
            self._own_terms = own
        return self._own_terms

    def port(self, dtype=torch.bfloat16):
        tm = ProSim(self.tcfg, device="cpu", dtype=dtype)
        load_flax_params(tm, self.params)
        return tm


@pytest.fixture(scope="module", params=list(CONFIGS))
def side(request):
    return Side(request.param)


def _loss_terms_dtypes(side, terms, jdtypes):
    """The port's loss terms carry the JAX bf16 terms' dtypes: the losses
    take the model's bf16 outputs where the JAX losses do, with no cast."""
    want = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    for k, v in jdtypes.items():
        assert terms[k].dtype == want[v], (side.name, k, terms[k].dtype, v)


def test_bf16_train_losses_match_jax(side):
    """The train-mode forward and every loss term at R = 1 and R = 2, each
    in the JAX bf16 term's dtype, by the 2x rule with the JAX bf16 term's
    own movement under a rounding-sized change of the weights taken into
    its side of the rule (at R = 2 the closed loop feeds step 0's rounding
    into step 1)."""
    tm = side.port()
    own = side.own_terms()
    for r in (1, 2):
        ref32, ref16 = ((side.grads(bits, side.params)[1] if r == 1 else side.terms2[bits])
                        for bits in (32, 16))
        out = tm.forward_train(side.tb[r], seed=0)
        terms = tlosses.paired_mse_k(side.tb[r], out, side.tcfg)
        _loss_terms_dtypes(side, terms, side.dtypes[r])
        assert out["motion_pred"].dtype == torch.bfloat16
        assert out["rollout_traj"].dtype == torch.float32  # the integrated state stays f32
        assert set(terms) == set(ref32)
        for k, v in ref32.items():
            err = abs(float(terms[k].detach()) - float(v))
            bar = 2 * max(abs(float(ref16[k]) - float(v)), own[r][k]) + LOSS_ATOL * max(
                abs(float(v)), 1.0)
            assert np.isfinite(err) and err <= bar, (side.name, r, k, err, bar)


def test_bf16_gradients_match_jax(side):
    """f32 gradients of the bf16 train loss at R = 1: each trained leaf
    within Side.grad_bar of the JAX f32 gradient; the frozen Llama body
    gets none. A ReLU whose input rounds to the other side of 0 in bf16
    moves a leaf's gradient by a whole row's contribution (at these weights
    an element of the text adapter's llm_to_cond.norm_0 output, in four
    identical rows, is slightly negative in f32 and slightly positive in
    the port's bf16, and llm_to_cond.norm_0.bias's gradient moves by more
    than its largest value): the JAX bf16 gradient takes such jumps under a
    rounding-sized change of its weights, and own16 measures them."""
    tm = side.port()
    toptim.build_optimizer(side.tcfg, tm)  # freezes the Llama body, as in a run
    out = tm.forward_train(side.tb[1], seed=0)
    loss = tlosses.paired_mse_k(side.tb[1], out, side.tcfg)["full_loss"]
    (loss * side.tcfg.TASK.MOTION_PRED.WEIGHT).backward()
    g32, g16 = (side.grads(bits, side.params)[3] for bits in (32, 16))
    for n, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and ".llm." in n and "lora" not in n, n
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        err, bar = np.abs(p.grad.numpy() - g32[n]).max(), side.grad_bar(side.params, g32, g16, n)
        assert err <= bar, (side.name, n, err, bar)


def test_two_bf16_train_steps_match_jax(side):
    """Two make_train_step steps of the bf16 model at the full LR, without
    clipping (GRAD_CLIP 0). Each step starts from the port's parameters;
    there the JAX package's bf16 and f32 losses and gradients are taken and
    the port's loss and gradient norm held to them by the 2x rule, so the
    second step's are compared at the same weights in all three.

    The parameters: after each step every trained leaf equals, within
    PARAM_ATOL, the JAX build_optimizer's update fed the port's own f32
    gradients (f32 parameters and moments, the AdamW step and decay of each
    group). After the first step, also by the 2x rule against the JAX bf16
    and f32 steps: the first update is LR * sign(g) per element, so a
    parameter is compared where the f32 gradient is above the bar its
    leaf's gradient is held to (Side.grad_bar); below it a port within the
    bar may take either sign, as the JAX bf16 step does. At least half the
    leaves the loss reaches are compared."""
    tm = side.port()
    topt, sched = toptim.build_optimizer(side.tcfg, tm)
    step = make_train_step(tm, topt, sched, side.tcfg)
    opt = joptim.build_optimizer(side.jcfg, side.params)
    update = jax.jit(opt.update)
    state = opt.init(side.params)  # fed the port's gradients
    params = side.params
    for i in range(2):
        ref = {}
        for bits in (32, 16):
            loss, _, g, g_sd = side.grads(bits, params)
            stepped = None
            if i == 0:  # the JAX package's own first step
                upd = update(g, opt.init(params), params)[0]
                stepped = flax_to_state_dict(_host(optax.apply_updates(params, upd)))
            ref[bits] = (loss, g_sd, float(optax.global_norm(g)), stepped)
        got = step(side.tb[1], 0)
        _two_x(float(got["full_loss"]), ref[16][0], ref[32][0], LOSS_ATOL * abs(ref[32][0]),
               (side.name, i, "loss"))
        _two_x(float(got["grad_norm"]), ref[16][2], ref[32][2], GRAD_ATOL * ref[32][2],
               (side.name, i, "norm"))
        mine = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
                for n, p in tm.named_parameters()}  # the frozen body's: zero, as JAX's
        upd, state = update(side.from_state_dict(mine), state, params)
        expect = flax_to_state_dict(_host(optax.apply_updates(params, upd)))
        compared = live = 0
        for n, p in tm.named_parameters():
            if not p.requires_grad:
                assert p.grad is None and np.array_equal(p.detach().numpy(), expect[n]), n
                continue
            st = topt.state[p]
            assert p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
            np.testing.assert_allclose(p.detach().numpy(), expect[n], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{side.name} step {i} {n}")
            g32 = ref[32][1][n]
            if i > 0 or not g32.any():
                continue  # the 2x rule at the first step, on leaves the loss reaches
            live += 1
            sure = np.abs(g32) > side.grad_bar(params, ref[32][1], ref[16][1], n)
            if sure.any():
                compared += 1
                _two_x(p.detach().numpy()[sure], ref[16][3][n][sure], ref[32][3][n][sure],
                       PARAM_ATOL, (side.name, i, n))
        assert i > 0 or compared >= 0.5 * live, (side.name, compared, live)
        params = side.to_flax(tm)


# ------------------------------------------------------------- port-only cases

BF16 = torch.bfloat16


def test_remat_policies_give_the_same_bf16_step():
    """TRAIN.REMAT_POLICY full and dots against none, at dropout 0.1, in
    bf16: the recomputes save and recompute bf16 tensors and draw the same
    dropout masks, so the f32 gradients are bitwise the same."""
    path = os.path.join(REPO, CONFIGS["no_text"][0])
    grads = {}
    for pol in ("none", "full", "dots"):
        cfg = get_config(path, SMALL_OPTS + ["TRAIN.REMAT_POLICY", pol])
        model = ProSim(cfg, device="cpu", dtype=BF16)
        init_params(model, seed=0)
        batch = make_synthetic_batch(cfg, seed=1, device="cpu", num_replan=2, **BATCH_KW)
        out = model.forward_train(batch, seed=5)
        tlosses.paired_mse_k(batch, out, cfg)["full_loss"].backward()
        grads[pol] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert len(grads["none"]) > 100
    for pol in ("full", "dots"):
        assert set(grads[pol]) == set(grads["none"])
        for n, g in grads["none"].items():
            assert g.dtype == torch.float32 and torch.equal(grads[pol][n], g), (pol, n)


def _trainer(tmp, name, extra=()):
    cfg = get_config(os.path.join(REPO, CONFIGS["no_text"][0]), SMALL_OPTS + [
        "EXPERIMENT_DIR", str(tmp), "EXPERIMENT_NAME", name, "CHECKPOINT_INTERVAL", "1",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.BATCH_SIZE", "2", *extra])
    trainer = Trainer(cfg, model=ProSim(cfg, device="cpu", dtype=BF16), device="cpu")
    trainer.setup()
    return trainer


def test_bf16_trainer_resumes_exactly(tmp_path):
    """A bf16-body model through Trainer.setup / fit: three steps in one run
    against one step, an auto-resume (LOAD_CHECKPOINT_TRAINER) and two
    more: bitwise the same f32 parameters and Adam state. Then the bf16
    M-replica validation rollout (the kernels' plain versions here) gives
    finite metrics."""
    batches = [make_synthetic_batch(_trainer(tmp_path, "probe").config, seed=s, device="cpu",
                                    num_replan=2, **BATCH_KW) for s in (2, 3, 4)]
    full = _trainer(tmp_path, "full")
    start = {n: p.detach().clone() for n, p in full.model.named_parameters()}
    full.fit(batches, max_steps=3)
    cut = _trainer(tmp_path, "cut")
    cut.fit(batches[:1], max_steps=1)
    assert find_latest_checkpoint(cut.run_dir)
    resumed = _trainer(tmp_path, "cut", ["LOAD_CHECKPOINT_TRAINER", "True"])
    assert resumed.step == 1 and resumed.model.dtype == BF16
    resumed.fit(batches[1:], max_steps=3)
    assert resumed.step == 3
    moved = 0
    for n, p in full.model.named_parameters():
        q = resumed.model.get_parameter(n)
        assert p.dtype == torch.float32 and torch.equal(p.detach(), q.detach()), n
        moved += not torch.equal(p.detach(), start[n])
    assert moved > 100
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    metrics = full.rollout_callback(batches[:1], m=2)
    assert metrics and all(np.isfinite(v) for v in metrics.values())


# ------------------------------------------------------- the bf16 gathers

def test_jax_bf16_site_gather_cuts_the_gradient():
    """A fault of the frozen JAX package that the port does not copy: its
    bf16 site_gather bit-packs the source rows (jax.lax.bitcast_convert_type,
    prosim_tpu/ops/attention.py:164-187), which has no gradient, so the rows'
    cotangent is exactly zero (the JAX bf16 train step gives the scene
    encoder none). _site_gather_unpacked gives bitwise the same values and
    the gradient of the port's gather, which is the f32 gather's rounded."""
    rng = np.random.default_rng(5)
    B, S, Q, K, D = 2, 12, 5, 4, 8
    x = jnp.asarray(rng.normal(size=(B, S, D)), jnp.bfloat16)
    pos, ori = (jnp.asarray(rng.normal(size=sh), jnp.float32) for sh in ((B, S, 2), (B, S)))
    idx = jnp.asarray(rng.integers(0, S, (B, Q, K)), jnp.int32)
    cot = jnp.asarray(rng.normal(size=(B, Q, K, D)), jnp.bfloat16)
    out, grads = {}, {}
    for name, fn in (("packed", jattn.site_gather), ("unpacked", _site_gather_unpacked)):
        f = lambda x_, fn=fn: fn(x_, pos, ori, idx)[0]  # noqa: E731
        out[name], vjp = jax.vjp(f, x)
        grads[name] = np.asarray(vjp(cot)[0], np.float32)
    assert out["packed"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(out["packed"], np.float32),
                          np.asarray(out["unpacked"], np.float32))
    assert not grads["packed"].any() and grads["unpacked"].any()
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_(True)
    from prosim_torch.ops.attention import _norm_stats
    from prosim_torch.ops.neighbors import gather_neighbors

    gathered = gather_neighbors(_norm_stats(xt), torch.from_numpy(np.asarray(idx)))
    np.testing.assert_array_equal(gathered.detach().float().numpy(),
                                  np.asarray(out["unpacked"], np.float32))
    gathered.backward(torch.from_numpy(np.asarray(cot, np.float32)).to(torch.bfloat16))
    ref32 = jax.vjp(lambda x_: _site_gather_unpacked(x_, pos, ori, idx)[0],
                    x.astype(jnp.float32))[1](cot.astype(jnp.float32))[0]
    _two_x(xt.grad.float().numpy(), grads["unpacked"], np.asarray(ref32), 2.0 ** -8, "grad")


def test_bf16_gather_backward_sums_like_xla_on_the_cpu():
    """The gather's backward in bf16, with long runs of one index (invalid
    neighbour slots gather row 0): PyTorch's index backward on the CPU adds
    the bf16 cotangents one at a time in slot order, each add rounded to
    bf16, as XLA:CPU's bf16 scatter does: the two are bitwise equal here,
    between 1e-2 and 1e-1 of the largest sum from the exact one at a
    1,600-slot run (an f32 sum rounded once is far closer). In the model
    the invalid slots carry zero cotangents (their softmax weight is 0), so
    the runs add zeros, which round nothing."""
    rng = np.random.default_rng(0)
    B, S, Q, K, D = 2, 64, 128, 32, 16
    idx = rng.integers(0, S, (B, Q, K)).astype(np.int32)
    idx[:, :, 20:] = 0
    cot = np.asarray(jnp.asarray(rng.normal(size=(B, Q, K, D))).astype(jnp.bfloat16), np.float32)

    def jgather(x, i):
        return jax.vmap(lambda xs, ii: xs[ii])(x, i)

    x = jnp.zeros((B, S, D), jnp.bfloat16)
    ref = jax.jit(lambda x_, i, c: jax.vjp(lambda y: jgather(y, i), x_)[1](c)[0]).lower(
        x, idx, cot.astype(jnp.bfloat16)).compile(
        compiler_options={"xla_allow_excess_precision": False})(x, idx, cot.astype(jnp.bfloat16))
    xt = torch.zeros((B, S, D), dtype=torch.bfloat16, requires_grad=True)
    from prosim_torch.ops.neighbors import gather_neighbors

    gather_neighbors(xt, torch.from_numpy(idx)).backward(torch.from_numpy(cot).to(torch.bfloat16))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(ref, np.float32))
    exact = np.zeros((B, S, D))
    for b in range(B):
        np.add.at(exact[b], idx[b].reshape(-1), cot[b].reshape(-1, D).astype(np.float64))
    err = np.abs(xt.grad.float().numpy() - exact).max() / np.abs(exact).max()
    assert 1e-2 < err < 1e-1  # the rounding of 1,600 sequential bf16 adds


def test_bf16_attention_keeps_no_f32_copy_of_its_tables():
    """The differentiable attention block in bf16 (attend_gathered) keeps
    its per-edge tables for the backward in bf16 only: no f32 tensor of a
    table's shape is saved (an f32 copy doubles a table, and on the card it
    took the no_text bf16 step at B=16 from 16.55 to 27.91 GiB on an
    NVIDIA H100 80GB HBM3 at 700 W, scripts/train_memory.py). Its values equal the f32 upcast formulation's
    bitwise; a table's gradient takes each product's contribution rounded
    to bf16, as the JAX package's einsum transposes round it, where the
    upcast formulation summed them in f32 first: within 2 bf16 ulps of the
    leaf's largest."""
    from prosim_torch.ops.edge_attn import attend_gathered

    g = torch.Generator().manual_seed(0)
    B, Q, K, H, D, Dp = 2, 5, 7, 2, 8, 6
    x_g = torch.randn(B, Q, K, D, generator=g).to(BF16).requires_grad_(True)
    z_r = torch.randn(B, Q, K, Dp, generator=g).to(BF16)
    qx = torch.randn(B, Q, H, D, generator=g).to(BF16).requires_grad_(True)
    qp = torch.randn(B, Q, H, Dp, generator=g).to(BF16).requires_grad_(True)
    valid = torch.rand(B, Q, K, generator=g) > 0.3
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        agg_x, agg_z, _ = attend_gathered(x_g, z_r, qx, qp, valid, 0.5)
    # a table's elements, in any layout einsum saves it in (the scores and
    # weights, [B,Q,K,H], have fewer)
    assert not [t.shape for t in saved
                if t.dtype == torch.float32 and t.numel() >= B * Q * K * Dp]
    (agg_x.float().sum() + agg_z.float().square().sum()).backward()
    grads = [t.grad.clone() for t in (x_g, qx, qp)]
    # the same block with the tables upcast by hand (what autograd kept before)
    ref = [t.detach().clone().requires_grad_(True) for t in (x_g, qx, qp)]
    x32, z32 = ref[0].float(), z_r.float()
    sim = (torch.einsum("bqhd,bqkd->bqkh", ref[1].float(), x32)
           + torch.einsum("bqhd,bqkd->bqkh", ref[2].float(), z32))
    sim = torch.where(valid[..., None], (sim * 0.5).to(BF16).float(), -torch.inf)
    m = sim.amax(2, keepdim=True)
    e = torch.where(valid[..., None], torch.exp(sim - m), 0.0).to(BF16).float()
    attn = (e / e.sum(2, keepdim=True).clamp_min(1e-9)).to(BF16)
    rx = torch.einsum("bqkh,bqkd->bqhd", attn.float(), x32).to(BF16)
    rz = torch.einsum("bqkh,bqkd->bqhd", attn.float(), z32).to(BF16)
    assert torch.equal(rx, agg_x) and torch.equal(rz, agg_z)
    (rx.float().sum() + rz.float().square().sum()).backward()
    for mine, theirs in zip(grads, (t.grad for t in ref)):
        assert mine.dtype == BF16
        bound = 2 * 2.0 ** -8 * float(theirs.float().abs().max())
        assert float((mine.float() - theirs.float()).abs().max()) <= bound
