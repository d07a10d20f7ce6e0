"""ProSim: promptable closed-loop traffic simulation model (port of
prosim_tpu/models/prosim.py).

`prepare` encodes the scene and prompts and builds the per-agent policy
embeddings once; `rollout` is the closed loop, a Python loop over R replan
steps (the JAX package's lax.scan). Per step:
  step_env  - rebuild the policy agents' obs history from their rolled-out
              state, non-policy agents replay logged futures (fut_obs), and
              the scene encoder's `update_obs` swaps (or fuses) the obs
              tokens, re-attending them with ATTN_UPDATE;
  policy    - a2p/m2p attention at the agents' current poses (the layer
              loop, or with FUSED_STACK the fused two-site stack, whose
              packed weights are made once per rollout), then its head;
  integrate - pick a mode among the top-k and integrate the chunk in f32.
In the eval modes `prepare`, `rollout`, each replan step and these three
open spans of the same names (prosim_torch/utils/tracing.py; docs/tracing.md).

With prompt conditions (PROMPT.CONDITION.TYPES) a condition transformer
runs at each of MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS: at
'prompt_encoder' on the prompt embeddings, at 'policy_decoder' on the
decoder's policy embeddings, where a text condition goes through the Llama
text path and its prompt-mask loss comes out as `prompt_loss_aux`. The
model is built directly on `device`, so a Llama3-8B text model never passes
through host memory.

Modes: the eval modes ('val', 'rollout', ...) run under
torch.inference_mode, deterministically, through the kernels. `mode="train"`
(`forward_train`) keeps the autograd graph: dropout in the scene encoder,
decoder and policy (the condition transformer is called deterministic, as
the JAX package calls it), `select_k_emd` picks the goal mode nearest the
logged goal, the mode pick among ROLLOUT.POLICY.TOP_K_TRAIN, the chunk is
detached unless MODEL.BPTT, and TRAIN.REMAT_POLICY checkpoints `prepare`
and each replan step ('full': recompute everything, 'dots': keep the matmul
outputs, 'none'). Each checkpointed region draws its dropout masks from a
generator it builds from an integer seed, so its recompute draws the same
masks (checkpoint restores only the default generators).

With a text condition the Llama runs inside the checkpointed `prepare`, as
in the JAX package (prosim_tpu/models/prosim.py:271-276). With
LlamaConfig.remat (Llama3-8B width) each of its blocks is also
checkpointed, so under REMAT_POLICY 'full' or 'dots' a train step runs each
block forward three times: in the forward, in `prepare`'s recompute (which
keeps only the block's input) and in the block's own recompute during the
backward. Without block remat (tiny()) it is twice; under 'none' it is
once, or twice with block remat.

`dtype` is the network's compute dtype (the JAX `ProSim(config, dtype)`;
like it, the model does not read MODEL.DTYPE). The parameters stay f32,
and each module casts where its JAX twin does: the scene encoder, prompt
encoder, decoder, policy and condition transformers compute in `dtype`,
the type and time one-hots are built in it, `step_env` writes back in the
logged buffers' dtype (f32), the policy takes the agents' poses in it, and
the trajectory state is integrated in f32
(prosim_tpu/models/prosim.py:195-208, :296-297, :346-351, :406-407, :435).
In bf16 the kernels run their bf16 instantiations. A bf16 model trains as
an f32 one does (`bench.py --mode train`'s default): the body computes in
bf16, the parameters and their gradients stay f32 (each cast's gradient
returns to the f32 leaf), the remat policies save and recompute bf16
tensors, and the losses take the bf16 outputs where the JAX losses do.
"""

import contextlib
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from prosim_torch.data.batch import SceneBatch, SceneTokens
from prosim_torch.models.condition.transformer import build_condition_transformer
from prosim_torch.models.decoder import build_decoder
from prosim_torch.models.policy import build_policy
from prosim_torch.models.prompt_encoder import build_prompt_encoder
from prosim_torch.models.scene_encoder import build_scene_encoder
from prosim_torch.utils import tracing
from prosim_torch.utils.geometry import (
    rel_traj_to_last_step,
    rel_vel_to_last_step,
    rotate_2d,
    wrap_angle,
)


def _topk_stable(x, k: int):
    """Indices of the k largest entries of the last dim, ties to the lower
    index (lax.top_k's order)."""
    return torch.sort(-x, dim=-1, stable=True)[1][..., :k]


def _grad_mode(mode: str):
    return contextlib.nullcontext() if mode == "train" else torch.inference_mode()


def _spans(mode: str):
    """The span opener of a call in `mode`: none in training, whose remat
    recomputes would open the spans again (prosim_torch/utils/tracing.py)."""
    return tracing.no_span if mode == "train" else tracing.span


# the matmul ops whose outputs TRAIN.REMAT_POLICY 'dots' keeps (the
# counterpart of jax.checkpoint_policies.dots_saveable). A bare mm is
# recomputed: ATen's linear on a 4-D input adds the bias into the mm output
# in place, and selective checkpointing refuses a kept tensor that changed.
_DOT_OPS = (torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class ProSim(nn.Module):
    def __init__(self, config, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.condition_locations = (list(config.MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS)
                                    if config.PROMPT.CONDITION.TYPES else [])
        with torch.device(device):
            self.scene_encoder = build_scene_encoder(config, dtype)
            self.prompt_encoder = build_prompt_encoder(config, dtype)
            self.decoder = build_decoder(config, dtype)
            self.policy = build_policy(config, dtype)
            for loc in self.condition_locations:
                self.add_module(f"condition_transformer_{loc}",
                                build_condition_transformer(config, dtype))

        self.hist_steps = config.DATASET.FORMAT.HISTORY.STEPS
        self.replan = config.ROLLOUT.POLICY.REPLAN_FREQ
        self.top_k = config.ROLLOUT.POLICY.TOP_K
        self.top_k_train = config.ROLLOUT.POLICY.TOP_K_TRAIN
        self.bptt = config.MODEL.BPTT
        self.remat_policy = config.TRAIN.REMAT_POLICY
        self.dt = config.DATASET.MOTION.DT
        self.pred_vel = config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL
        self.pred_gmm = config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM
        self.ref_frame_quirk = config.MODEL.PARITY.REFERENCE_STEP_ENV_FRAME
        self.to(device)
        self.eval()

    def _remat(self, fn, *args):
        """fn(*args) under TRAIN.REMAT_POLICY (prosim_tpu/models/prosim.py:253-264)."""
        pol = self.remat_policy
        if pol == "none":
            return fn(*args)
        if pol == "full":
            return ckpt.checkpoint(fn, *args, use_reentrant=False)
        if pol == "dots":
            return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
        raise ValueError(f"unknown TRAIN.REMAT_POLICY {pol!r}")

    @staticmethod
    def _seeded(seed: int, device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    # ------------------------------------------------------------ traj state
    def init_agent_trajs(self, batch: SceneBatch, total_steps: int):
        """Seed trajectory buffers from observed history
        (reference: traj_sam.py:597-633)."""
        obs, prompt = batch.init_obs, batch.prompt
        B, N = prompt.mask.shape
        dev = obs.feat.device
        safe_idx = prompt.obs_index.long().clamp_min(0)
        bidx = torch.arange(B, device=dev)[:, None]
        feat = obs.feat[bidx, safe_idx]  # [B, N, Th, C]
        init_pos = obs.pos[bidx, safe_idx]
        init_heading = obs.ori[bidx, safe_idx]
        # The integrated state stays float32 whatever the network computes
        # in: positions accumulate over 80+ steps and reach ~100 m.
        traj = torch.zeros((B, N, total_steps, 4), dtype=torch.float32, device=dev)
        traj[:, :, : self.hist_steps] = torch.nan_to_num(feat[..., :4]).float()
        vel = torch.zeros((B, N, total_steps, 2), dtype=torch.float32, device=dev)
        if self.pred_vel:
            vel[:, :, : self.hist_steps] = torch.nan_to_num(feat[..., 4:6]).float()
        return traj, vel, init_pos, init_heading

    # ---------------------------------------------------------------- select
    def select_k_emd(self, policy_emd, batch: SceneBatch, mode: str,
                     generator: Optional[torch.Generator]):
        """Pick 1 of K goal-conditioned policy embeddings
        (reference: traj_sam.py:402-439). Identity when goal heads are off."""
        emd = policy_emd["emd"]
        if "goal_point" not in policy_emd or emd.ndim == 3:
            return policy_emd
        B, N, K, _ = emd.shape
        if mode == "train":  # the mode nearest the logged goal
            gt_goal = batch.io_pairs.goal[:, 0]  # [B, N, 2]
            idx = torch.linalg.vector_norm(
                policy_emd["goal_point"] - gt_goal[:, :, None, :], dim=-1).argmin(dim=-1)
        else:
            k = min(self.top_k, K)
            topk_idx = _topk_stable(policy_emd["goal_prob"], k)
            r = torch.randint(0, k, (B, N), generator=generator, device=emd.device)
            idx = topk_idx.gather(-1, r[..., None])[..., 0]
        policy_emd = dict(policy_emd)
        policy_emd["select_idx"] = idx.to(torch.int32)  # lax.top_k's index dtype
        policy_emd["emd"] = emd.gather(2, idx[..., None, None].expand(B, N, 1, emd.shape[-1]))[:, :, 0]
        policy_emd["goal"] = policy_emd["goal_point"].gather(
            2, idx[..., None, None].expand(B, N, 1, 2))[:, :, 0]
        return policy_emd

    # --------------------------------------------------------------- rollout
    def prepare(self, batch: SceneBatch, mode: str = "val",
                generator: Optional[torch.Generator] = None):
        """Encode scene + prompts and build per-agent policy embeddings (the
        once-per-scene half; M replicas reuse it). In train mode `generator`
        draws the dropout masks."""
        span = _spans(mode)
        with _grad_mode(mode), span("prepare"):
            deterministic = mode != "train"
            with span("scene_encoder"):
                scene = self.scene_encoder(batch.init_obs, batch.init_map, deterministic,
                                           generator)
            with span("prompt_encoder"):
                prompt_emb = self.encode_prompt(batch)
            with span("decoder"):
                policy_emd = self.generate_policy(batch, scene, prompt_emb, deterministic,
                                                  generator)
            with span("select_k"):
                return scene, self.select_k_emd(policy_emd, batch, mode, generator)

    def encode_prompt(self, batch: SceneBatch):
        prompt_emb = self.prompt_encoder(batch.prompt)
        if "prompt_encoder" in self.condition_locations:
            prompt_emb, _ = self.condition_transformer_prompt_encoder(
                batch.conditions, prompt_emb, batch.prompt)
        return prompt_emb

    def generate_policy(self, batch: SceneBatch, scene: SceneTokens, prompt_emb,
                        deterministic: bool = True, generator=None) -> dict:
        """The decoder's policy embeddings, conditioned at 'policy_decoder';
        the text path's aux losses ride along as 'prompt_loss_aux'."""
        policy_emd = self.decoder(scene, batch.prompt, prompt_emb, deterministic, generator)
        policy_emd["goal"] = batch.prompt.goal_point
        if "policy_decoder" in self.condition_locations:
            emd, aux = self.condition_transformer_policy_decoder(
                batch.conditions, policy_emd["emd"], batch.prompt)
            policy_emd["emd"] = emd
            if aux is not None:
                policy_emd["prompt_loss_aux"] = aux
        return policy_emd

    def forward(self, batch: SceneBatch, mode: str = "val",
                generator: Optional[torch.Generator] = None, seed: int = 0) -> dict:
        """Full closed-loop pass: prepare, then the replan loop. mode="train"
        is `forward_train(batch, seed)`."""
        if mode == "train":
            return self.forward_train(batch, seed)
        scene, policy_emd = self.prepare(batch, mode, generator)
        return self.rollout(batch, scene, policy_emd, mode, generator)

    def forward_train(self, batch: SceneBatch, seed: int = 0) -> dict:
        """The train-mode closed loop, differentiable. `seed` makes the
        integer seeds of `prepare` and of each replan step, as the JAX package
        splits its key (prosim_tpu/models/prosim.py:266-283, 386-389)."""
        seeds = torch.Generator().manual_seed(seed)
        R = int(batch.fut_obs.feat.shape[1])
        prep_seed, *step_seeds = torch.randint(0, 2**62, (R + 1,), generator=seeds).tolist()
        dev = batch.init_obs.feat.device
        scene, policy_emd = self._remat(
            lambda b, s: self.prepare(b, "train", self._seeded(s, dev)), batch, prep_seed)
        return self._rollout(batch, scene, policy_emd, "train", step_seeds=step_seeds)

    def _agent_pose(self, traj, cursor, init_pos, init_heading):
        last = traj[:, :, cursor - 1]
        if self.ref_frame_quirk:
            # reference: traj_sam.py:211-212 (no init_heading rotation)
            pos = init_pos + last[..., :2]
        else:
            pos = init_pos + rotate_2d(last[..., :2], init_heading)
        theta = wrap_angle(torch.atan2(last[..., 2], last[..., 3]) + init_heading)
        return pos, theta

    def _step_env(self, batch, scene, traj, vel, r, cursor, init_pos, init_heading,
                  type_onehot, time_onehot, deterministic=True, generator=None):
        """Rebuild the obs of the policy agents from their rolled-out state,
        scatter them over the logged obs of step r, and update the obs
        tokens (`update_obs`; with ATTN_UPDATE its re-attention drops out in
        training, from `generator`)."""
        Th = self.hist_steps
        fo = batch.fut_obs
        prompt = batch.prompt
        fo_feat, fo_mask = fo.feat[:, r], fo.mask[:, r]
        fo_pos, fo_ori = fo.pos[:, r], fo.ori[:, r]
        obs_index = fo.obs_index[:, r].long()  # [B, N]

        window = traj[:, :, cursor - Th - 2 : cursor]  # last Th+2 poses
        rel = rel_traj_to_last_step(window)  # [B, N, Th+2, 4]
        if self.pred_vel:
            rel_v = rel_vel_to_last_step(window, vel[:, :, cursor - Th - 1 : cursor])
        else:
            rel_v = torch.diff(rel[..., :2], dim=-2) / self.dt
        rel_acc = torch.diff(rel_v, dim=-2) / self.dt
        vel_acc = torch.cat([rel_v[:, :, 1:], rel_acc], dim=-1)  # [B, N, Th, 4]
        B, N = rel.shape[:2]
        feat_n = torch.cat([
            rel[:, :, -Th:],
            vel_acc,
            prompt.extent[:, :, None, :].expand(B, N, Th, 2),
            type_onehot[:, :, None, :].expand(B, N, Th, 3),
            time_onehot.expand(B, N, Th, Th),
        ], dim=-1)  # [B, N, Th, C_obs]
        pos_n, theta_n = self._agent_pose(traj, cursor, init_pos, init_heading)

        # scatter policy agents into the all-agent obs; slots of invalid
        # agents route to a spare row A that is dropped afterwards (the JAX
        # scatter's mode="drop")
        A = fo_feat.shape[1]
        tgt = torch.where(prompt.mask & (obs_index >= 0), obs_index, A)
        bidx = torch.arange(B, device=tgt.device)[:, None]

        def scatter(base, val):
            buf = torch.cat([base, base[:, :1]], dim=1)
            buf[bidx, tgt] = val.to(buf.dtype) if torch.is_tensor(val) else val
            return buf[:, :A]

        return self.scene_encoder.update_obs(
            scene,
            scatter(fo_feat, feat_n),
            scatter(fo_mask, True),
            scatter(fo_pos, pos_n),
            scatter(fo_ori, theta_n),
            deterministic,
            generator,
        )

    def rollout(self, batch: SceneBatch, scene: SceneTokens, policy_emd: dict,
                mode: str = "val", generator: Optional[torch.Generator] = None) -> dict:
        """The closed loop over R replan steps from prepared embeddings, in an
        eval mode (training goes through `forward_train`)."""
        if mode == "train":
            raise ValueError("the train-mode rollout is forward_train(batch, seed)")
        with torch.inference_mode():
            return self._rollout(batch, scene, policy_emd, mode, generator=generator)

    def _rollout(self, batch, scene, policy_emd, mode, generator=None, step_seeds=None):
        with _spans(mode)("rollout"):
            return self._rollout_steps(batch, scene, policy_emd, mode, generator, step_seeds)

    def _rollout_steps(self, batch, scene, policy_emd, mode, generator, step_seeds):
        Th = self.hist_steps
        R = int(batch.fut_obs.feat.shape[1])
        total = Th + R * self.replan
        traj, vel, init_pos, init_heading = self.init_agent_trajs(batch, total)
        prompt = batch.prompt
        dev = traj.device
        # one_hot(type - 1, 3): padding agents (type 0) get all zeros
        type_onehot = (prompt.agent_type.long()[..., None] - 1
                       == torch.arange(3, device=dev)).to(self.dtype)
        time_onehot = torch.eye(Th, dtype=self.dtype, device=dev)
        consts = (init_pos, init_heading, type_onehot, time_onehot)
        train = mode == "train"
        packed = None if train else self.policy.pack_fused()  # None unless the fused stack runs
        carry = (scene.tokens, scene.pos, scene.ori, scene.mask, traj, vel)
        steps = []
        for r in range(R):
            if train:
                carry, ys = self._remat(
                    lambda c, r_, s: self._step(batch, scene.num_map, policy_emd, consts, c, r_,
                                                mode, self._seeded(s, dev), None),
                    carry, r, step_seeds[r])
            else:
                with tracing.span("step", r):
                    carry, ys = self._step(batch, scene.num_map, policy_emd, consts, carry, r,
                                           mode, generator, packed)
            steps.append(ys)
        traj, vel = carry[4], carry[5]
        output = {
            # per-step predictions stacked on a leading replan axis [R, B, N, ...]
            "motion_pred": torch.stack([ys["motion_pred"] for ys in steps]),
            "motion_prob": torch.stack([ys["motion_prob"] for ys in steps]),
            # final rollout (local frame of each agent's obs origin)
            "rollout_traj": traj[:, :, Th:],
            "rollout_vel": vel[:, :, Th:],
            "init_pos": init_pos,
            "init_heading": init_heading,
            "agent_mask": prompt.mask,
        }
        if "reconst_pred" in steps[0]:
            output["reconst_pred"] = torch.stack([ys["reconst_pred"] for ys in steps])
        for key in ("prompt_loss_aux", "goal_prob", "goal_point", "select_idx", "goal"):
            if key in policy_emd:
                output[key] = policy_emd[key]
        return output

    def _step(self, batch, num_map, policy_emd, consts, carry, r, mode, generator, packed):
        """One replan step: (scene tokens, pos, ori, mask, traj, vel) -> the
        next carry and the step's predictions. In train mode `generator`
        draws the dropout masks and the mode pick."""
        Th = self.hist_steps
        init_pos, init_heading, type_onehot, time_onehot = consts
        tokens, spos, sori, smask, traj, vel = carry
        scene = SceneTokens(tokens=tokens, pos=spos, ori=sori, mask=smask, num_map=num_map)
        prompt = batch.prompt
        mask = prompt.mask
        train = mode == "train"
        span = _spans(mode)
        cursor = Th + r * self.replan
        pos_now, theta_now = self._agent_pose(traj, cursor, init_pos, init_heading)
        if r > 0:
            with span("step_env"):
                scene = self._step_env(batch, scene, traj, vel, r, cursor, init_pos,
                                       init_heading, type_onehot, time_onehot, not train,
                                       generator)
        dt = self.dtype
        with span("policy"):
            out = self.policy(policy_emd, scene, pos_now.to(dt), theta_now.to(dt), mask,
                              prompt.agent_type, packed=packed, deterministic=not train,
                              generator=generator)
        with span("integrate"):
            return self._integrate(out, traj, vel, cursor, mask, train, generator, scene)

    def _integrate(self, out, traj, vel, cursor, mask, train, generator, scene):
        """Pick a mode among the top-k and integrate its chunk into the f32
        trajectory state: the next carry and the step's predictions."""
        # mode selection among the top-k (reference: traj_sam.py:301-313)
        probs = out["motion_prob"]  # [B, N, K]
        k_eff = min(self.top_k_train if train else self.top_k, probs.shape[-1])
        if k_eff == 1:
            sel = torch.argmax(probs, dim=-1)  # first maximum, as jnp.argmax
        else:
            topk_idx = _topk_stable(probs, k_eff)
            rand = torch.randint(0, k_eff, probs.shape[:2], generator=generator,
                                 device=probs.device)
            sel = topk_idx.gather(-1, rand[..., None])[..., 0]
        mp = out["motion_pred"]
        chunk = mp.gather(2, sel[:, :, None, None, None].expand(
            *mp.shape[:2], 1, *mp.shape[3:]))[:, :, 0, : self.replan].float()
        if not self.bptt:
            chunk = chunk.detach()

        last = traj[:, :, cursor - 1]
        last_theta = torch.atan2(last[..., 2], last[..., 3])  # [B, N]
        xy = rotate_2d(chunk[..., :2], last_theta[..., None]) + last[..., None, :2]
        th = wrap_angle(last_theta[..., None] + chunk[..., 2])
        new_seg = torch.cat([xy, torch.sin(th)[..., None], torch.cos(th)[..., None]], dim=-1)
        S = new_seg.shape[2]
        # out of place: a checkpointed step's inputs must not change afterwards
        traj = traj.slice_scatter(torch.where(mask[..., None, None], new_seg, 0.0),
                                  dim=2, start=cursor, end=cursor + S)
        if self.pred_vel:
            vch = chunk[..., 6:8] if self.pred_gmm else chunk[..., 3:5]
            vseg = rotate_2d(vch, last_theta[..., None])
            vel = vel.slice_scatter(torch.where(mask[..., None, None], vseg, 0.0),
                                    dim=2, start=cursor, end=cursor + S)
        ys = {"motion_pred": mp, "motion_prob": probs}
        if "reconst_pred" in out:
            ys["reconst_pred"] = out["reconst_pred"]
        return (scene.tokens, scene.pos, scene.ori, scene.mask, traj, vel), ys
