"""ProSim: promptable closed-loop traffic simulation model (port of
prosim_tpu/models/prosim.py), eval mode.

`prepare` encodes the scene and prompts and builds the per-agent policy
embeddings once; `rollout` is the closed loop, a Python loop over R replan
steps (the JAX package's lax.scan). Per step:
  step_env  - rebuild the policy agents' obs history from their rolled-out
              state, non-policy agents replay logged futures (fut_obs), and
              the obs tokens of the scene are swapped;
  policy    - a2p/m2p attention at the agents' current poses (the layer
              loop, or with FUSED_STACK the fused two-site stack, whose
              packed weights are made once per rollout), anchor head;
  integrate - pick a mode among the top-k and integrate the chunk in f32.

With prompt conditions (PROMPT.CONDITION.TYPES) a condition transformer
runs at each of MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS: at
'prompt_encoder' on the prompt embeddings, at 'policy_decoder' on the
decoder's policy embeddings, where a text condition goes through the Llama
text path and its prompt-mask loss comes out as `prompt_loss_aux`. The
model is built directly on `device`, so a Llama3-8B text model never passes
through host memory.

Training (`mode="train"`) is still to be ported (ROADMAP.md queue A7); it
raises NotImplementedError.
"""

from typing import Optional

import torch
from torch import nn

from prosim_torch.data.batch import SceneBatch, SceneTokens
from prosim_torch.models.condition.transformer import build_condition_transformer
from prosim_torch.models.decoder import build_decoder
from prosim_torch.models.policy import build_policy
from prosim_torch.models.prompt_encoder import build_prompt_encoder
from prosim_torch.models.scene_encoder import build_scene_encoder
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


class ProSim(nn.Module):
    def __init__(self, config, device="cuda"):
        super().__init__()
        self.config = config
        self.condition_locations = (list(config.MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS)
                                    if config.PROMPT.CONDITION.TYPES else [])
        with torch.device(device):
            self.scene_encoder = build_scene_encoder(config)
            self.prompt_encoder = build_prompt_encoder(config)
            self.decoder = build_decoder(config)
            self.policy = build_policy(config)
            for loc in self.condition_locations:
                self.add_module(f"condition_transformer_{loc}", build_condition_transformer(config))

        self.hist_steps = config.DATASET.FORMAT.HISTORY.STEPS
        self.replan = config.ROLLOUT.POLICY.REPLAN_FREQ
        self.top_k = config.ROLLOUT.POLICY.TOP_K
        self.dt = config.DATASET.MOTION.DT
        self.pred_vel = config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL
        self.pred_gmm = config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM
        self.ref_frame_quirk = config.MODEL.PARITY.REFERENCE_STEP_ENV_FRAME
        self.to(device)
        self.eval()

    @staticmethod
    def _check_mode(mode: str):
        if mode == "train":
            raise NotImplementedError(
                "mode='train' is not ported yet (see ROADMAP.md queue A7)")

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
        k = min(self.top_k, K)
        topk_idx = _topk_stable(policy_emd["goal_prob"], k)
        r = torch.randint(0, k, (B, N), generator=generator, device=emd.device)
        idx = topk_idx.gather(-1, r[..., None])[..., 0]
        policy_emd = dict(policy_emd)
        policy_emd["select_idx"] = idx
        policy_emd["emd"] = emd.gather(2, idx[..., None, None].expand(B, N, 1, emd.shape[-1]))[:, :, 0]
        policy_emd["goal"] = policy_emd["goal_point"].gather(
            2, idx[..., None, None].expand(B, N, 1, 2))[:, :, 0]
        return policy_emd

    # --------------------------------------------------------------- rollout
    @torch.inference_mode()
    def prepare(self, batch: SceneBatch, mode: str = "val",
                generator: Optional[torch.Generator] = None):
        """Encode scene + prompts and build per-agent policy embeddings (the
        once-per-scene half; M replicas reuse it)."""
        self._check_mode(mode)
        scene = self.scene_encoder(batch.init_obs, batch.init_map)
        prompt_emb = self.encode_prompt(batch)
        policy_emd = self.generate_policy(batch, scene, prompt_emb)
        policy_emd = self.select_k_emd(policy_emd, batch, mode, generator)
        return scene, policy_emd

    def encode_prompt(self, batch: SceneBatch):
        prompt_emb = self.prompt_encoder(batch.prompt)
        if "prompt_encoder" in self.condition_locations:
            prompt_emb, _ = self.condition_transformer_prompt_encoder(
                batch.conditions, prompt_emb, batch.prompt)
        return prompt_emb

    def generate_policy(self, batch: SceneBatch, scene: SceneTokens, prompt_emb) -> dict:
        """The decoder's policy embeddings, conditioned at 'policy_decoder';
        the text path's aux losses ride along as 'prompt_loss_aux'."""
        policy_emd = self.decoder(scene, batch.prompt, prompt_emb)
        policy_emd["goal"] = batch.prompt.goal_point
        if "policy_decoder" in self.condition_locations:
            emd, aux = self.condition_transformer_policy_decoder(
                batch.conditions, policy_emd["emd"], batch.prompt)
            policy_emd["emd"] = emd
            if aux is not None:
                policy_emd["prompt_loss_aux"] = aux
        return policy_emd

    @torch.inference_mode()
    def forward(self, batch: SceneBatch, mode: str = "val",
                generator: Optional[torch.Generator] = None) -> dict:
        """Full closed-loop pass: prepare, then the replan loop."""
        scene, policy_emd = self.prepare(batch, mode, generator)
        return self.rollout(batch, scene, policy_emd, mode, generator)

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
                  type_onehot, time_onehot):
        """Rebuild the obs of the policy agents from their rolled-out state,
        scatter them over the logged obs of step r, and swap the obs tokens."""
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
        )

    @torch.inference_mode()
    def rollout(self, batch: SceneBatch, scene: SceneTokens, policy_emd: dict,
                mode: str = "val", generator: Optional[torch.Generator] = None) -> dict:
        """The closed loop over R replan steps from prepared embeddings."""
        self._check_mode(mode)
        Th = self.hist_steps
        R = int(batch.fut_obs.feat.shape[1])
        total = Th + R * self.replan
        traj, vel, init_pos, init_heading = self.init_agent_trajs(batch, total)
        prompt = batch.prompt
        dev = traj.device
        # one_hot(type - 1, 3): padding agents (type 0) get all zeros
        type_onehot = (prompt.agent_type.long()[..., None] - 1
                       == torch.arange(3, device=dev)).float()
        time_onehot = torch.eye(Th, device=dev)
        mask = prompt.mask

        packed = self.policy.pack_fused()  # None unless the fused stack runs
        motion_preds, motion_probs, reconst_preds = [], [], []
        for r in range(R):
            cursor = Th + r * self.replan
            pos_now, theta_now = self._agent_pose(traj, cursor, init_pos, init_heading)
            if r > 0:
                scene = self._step_env(batch, scene, traj, vel, r, cursor, init_pos,
                                       init_heading, type_onehot, time_onehot)
            out = self.policy(policy_emd, scene, pos_now, theta_now, mask, prompt.agent_type,
                              packed=packed)

            # mode selection among the top-k (reference: traj_sam.py:301-313)
            probs = out["motion_prob"]  # [B, N, K]
            k_eff = min(self.top_k, probs.shape[-1])
            if k_eff == 1:
                sel = torch.argmax(probs, dim=-1)  # first maximum, as jnp.argmax
            else:
                topk_idx = _topk_stable(probs, k_eff)
                rand = torch.randint(0, k_eff, probs.shape[:2], generator=generator, device=dev)
                sel = topk_idx.gather(-1, rand[..., None])[..., 0]
            mp = out["motion_pred"]
            chunk = mp.gather(2, sel[:, :, None, None, None].expand(
                *mp.shape[:2], 1, *mp.shape[3:]))[:, :, 0, : self.replan].float()

            last = traj[:, :, cursor - 1]
            last_theta = torch.atan2(last[..., 2], last[..., 3])  # [B, N]
            xy = rotate_2d(chunk[..., :2], last_theta[..., None]) + last[..., None, :2]
            th = wrap_angle(last_theta[..., None] + chunk[..., 2])
            new_seg = torch.cat([xy, torch.sin(th)[..., None], torch.cos(th)[..., None]], dim=-1)
            S = new_seg.shape[2]
            traj[:, :, cursor : cursor + S] = torch.where(mask[..., None, None], new_seg, 0.0)
            if self.pred_vel:
                vch = chunk[..., 6:8] if self.pred_gmm else chunk[..., 3:5]
                vseg = rotate_2d(vch, last_theta[..., None])
                vel[:, :, cursor : cursor + S] = torch.where(mask[..., None, None], vseg, 0.0)
            motion_preds.append(mp)
            motion_probs.append(probs)
            if "reconst_pred" in out:
                reconst_preds.append(out["reconst_pred"])

        output = {
            # per-step predictions stacked on a leading replan axis [R, B, N, ...]
            "motion_pred": torch.stack(motion_preds),
            "motion_prob": torch.stack(motion_probs),
            # final rollout (local frame of each agent's obs origin)
            "rollout_traj": traj[:, :, Th:],
            "rollout_vel": vel[:, :, Th:],
            "init_pos": init_pos,
            "init_heading": init_heading,
            "agent_mask": mask,
        }
        if reconst_preds:
            output["reconst_pred"] = torch.stack(reconst_preds)
        for key in ("prompt_loss_aux", "goal_prob", "goal_point", "select_idx", "goal"):
            if key in policy_emd:
                output[key] = policy_emd[key]
        return output
