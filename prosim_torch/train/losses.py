"""Loss subsystem (port of prosim_tpu/train/losses.py).

The reference's loss semantics on padded [B, N, T] tensors
(reference: prosim/loss/loss_func.py):

  * closed-form rollout re-integration of per-step delta chunks into the full
    horizon trajectory (rollout_traj, loss_func.py:215-248)
  * masked huber/L1 rollout distance on pos/heading/vel (loss_func.py:315-361)
  * k-way step loss with closest-endpoint mode selection (loss_func.py:10-171)
  * goal reconstruction + prompt-mask aux losses (loss_func.py:490-607)
  * per-condition-type rollout-loss breakdown (loss_func.py:376-402)
"""

from typing import Dict

import torch

from prosim_torch.core.registry import registry
from prosim_torch.parallel.mesh import global_count
from prosim_torch.utils.geometry import rotate_2d, wrap_angle


def huber(x, y, delta=1.0):
    d = x - y
    a = d.abs()
    return torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))


def _criterion(config):
    if config.LOSS.TRAJ_CRITERION.TYPE == "mse":
        return lambda a, b: (a - b) ** 2
    delta = config.LOSS.TRAJ_CRITERION.HUBER_DELTA
    return lambda a, b: huber(a, b, delta)


def _pick(x, idx, dim):
    """x.gather along `dim` at idx (idx has x's shape up to dim, then 1)
    with the index broadcast over x's trailing dims; the picked dim is
    dropped."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - idx.ndim))
    return x.gather(dim, idx.expand(*x.shape[:dim], 1, *x.shape[dim + 1:])).squeeze(dim)


def rollout_traj(traj, rollout_steps):
    """Closed-form re-integration of per-replan-step local chunks.

    traj [B, N, T, S, D>=3]: chunk t holds cumulative (dx, dy) offsets and
    cumulative heading offsets in the frame of the agent's pose at replan
    step t. Returns [B, N, T*rollout_steps, D] in the frame of step 0.
    """
    B, N, T, S, D = traj.shape
    pred_vel = D == 5

    # heading anchor of each chunk = cumsum of previous chunks' total rotation
    dtheta = traj[..., rollout_steps - 1, 2]  # [B, N, T]
    theta = torch.cumsum(dtheta, dim=-1)
    theta = torch.cat([torch.zeros_like(theta[..., :1]), theta[..., :-1]], dim=-1)
    theta = wrap_angle(theta)

    # per-step deltas within each chunk
    dx = torch.diff(traj[..., :2], dim=-2)
    dx = torch.cat([traj[..., :1, :2], dx], dim=-2)  # [B, N, T, S, 2]

    dx_rot = rotate_2d(dx, theta[..., None])
    dx_rot = dx_rot[..., :rollout_steps, :].reshape(B, N, -1, 2)
    xy = torch.cumsum(dx_rot, dim=-2)

    th = traj[..., :rollout_steps, 2] + theta[..., None]
    th = wrap_angle(th.reshape(B, N, -1))

    out = torch.cat([xy, th[..., None]], dim=-1)
    if pred_vel:
        vel = rotate_2d(traj[..., :rollout_steps, 3:5], theta[..., None])
        out = torch.cat([out, vel.reshape(B, N, -1, 2)], dim=-1)
    return out


def compute_rollout_loss(tgt_rt, pred_rt, step_valid, config, gmm_params=None):
    """tgt_rt/pred_rt [B, N, T*, D], step_valid [B, N, T*] bool. When the
    policy emits GMM parameters the position term becomes the bivariate NLL
    (reference: loss_func.py:322-326)."""
    crit = _criterion(config)

    if gmm_params is not None:
        pos = gmm_nll(tgt_rt[..., :2], pred_rt[..., :2], gmm_params)
    else:
        pos = crit(tgt_rt[..., :2], pred_rt[..., :2]).sum(-1)
    tgt_h = torch.stack([torch.sin(tgt_rt[..., 2]), torch.cos(tgt_rt[..., 2])], dim=-1)
    pred_h = torch.stack([torch.sin(pred_rt[..., 2]), torch.cos(pred_rt[..., 2])], dim=-1)
    head = (tgt_h - pred_h).abs().sum(-1)

    dists = {"pos": pos, "heading": head}
    if tgt_rt.shape[-1] == 5:
        dists["vel"] = crit(tgt_rt[..., 3:], pred_rt[..., 3:]).sum(-1)

    agent_valid = step_valid.any(dim=-1)
    denom_t = step_valid.sum(dim=-1).clamp_min(1)
    denom_a = global_count(agent_valid)

    loss, per_agent = {}, {}
    for k, d in dists.items():
        dm = torch.where(step_valid, d, 0.0)
        step_mean = dm.sum(dim=-1) / denom_t  # [B, N]
        loss[k] = torch.where(agent_valid, step_mean, 0.0).sum() / denom_a
        per_agent[k] = step_mean
    per_agent["agent_valid"] = agent_valid
    return loss, per_agent


def step_loss_k_way(tgt, tgt_valid, pred, prob, config):
    """K-way chunk loss with closest-endpoint mode selection.

    tgt [*, S, D], tgt_valid [*, S, D] bool, pred [*, K, S, Dp], prob [*, K].
    """
    crit = _criterion(config)
    lead = pred.ndim - 3  # the index of the K axis

    gmm = None
    if config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM and (
        pred.shape[-1] == tgt.shape[-1] + 3
    ):
        # PRED_GMM columns [x, y, h, log_std1, log_std2, rho, (xd, yd)]
        # (reference: loss_func.py:137-149)
        gmm = pred[..., 3:6]
        pred = torch.cat([pred[..., :3], pred[..., 6:]], dim=-1)

    t_mask = tgt_valid.all(-1)  # [*, S]
    idx_range = torch.arange(t_mask.shape[-1], device=t_mask.device)
    last_valid = torch.where(t_mask, idx_range, -1).amax(dim=-1)  # [*]
    safe_last = last_valid.clamp_min(0)
    tgt_end = _pick(tgt, safe_last, lead)[..., :2]                  # [*, 2]
    pred_end = _pick(pred, safe_last[..., None].expand(*safe_last.shape, pred.shape[lead]),
                     lead + 1)[..., :2]                              # [*, K, 2]
    end_dist = crit(tgt_end[..., None, :], pred_end).mean(-1)  # [*, K]
    min_idx = end_dist.argmin(dim=-1)  # [*]

    best = _pick(pred, min_idx, lead)  # [*, S, Dp]

    pos_mask = tgt_valid[..., :2]
    if gmm is not None:
        # bivariate NLL position term (reference: loss_func.py:146-149)
        best_gmm = _pick(gmm, min_idx, lead)
        nll = gmm_nll(tgt[..., :2], best[..., :2], best_gmm)  # [*, S]
        m2 = pos_mask.all(-1)
        pos_l = torch.where(m2, nll, 0.0).sum() / global_count(m2)
    else:
        pos = torch.where(pos_mask, crit(tgt[..., :2], best[..., :2]), 0.0)
        pos_l = pos.sum() / global_count(pos_mask) * 2

    tgt_h = torch.stack([torch.sin(tgt[..., 2]), torch.cos(tgt[..., 2])], dim=-1)
    pred_h = torch.stack([torch.sin(best[..., 2]), torch.cos(best[..., 2])], dim=-1)
    h_mask = tgt_valid[..., 2:3].repeat_interleave(2, dim=-1)
    head = torch.where(h_mask, (tgt_h - pred_h).abs(), 0.0)
    head_l = head.sum() / global_count(h_mask) * 2

    cls_mask = tgt_valid[..., 0].any(-1)
    logp = torch.log_softmax(prob, dim=-1)
    cls = -logp.gather(-1, min_idx[..., None])[..., 0]
    cls_l = torch.where(cls_mask, cls, 0.0).sum() / global_count(cls_mask)

    result = {
        "pos_loss": pos_l * config.LOSS.STEP_TRAJ.POS_WEIGHT,
        "head_loss": head_l * config.LOSS.STEP_TRAJ.HEAD_WEIGHT,
        "cls_loss": cls_l * config.LOSS.STEP_TRAJ.CLS_WEIGHT,
    }
    if tgt.shape[-1] >= 5:
        v_mask = tgt_valid[..., 3:5]
        vel = torch.where(v_mask, (tgt[..., 3:5] - best[..., 3:5]).abs(), 0.0)
        vel_l = vel.sum() / global_count(v_mask) * 2
        result["vel_loss"] = vel_l * config.LOSS.STEP_TRAJ.VEL_WEIGHT
    result["full_loss"] = sum(result.values())
    return result, min_idx


def _scene_frame(traj_rt, base_pos, base_ori):
    """[B, N, T, >=3] (x, y, heading) in each agent's t=0 frame -> the scene
    frame [B, N, T, 3]."""
    xy = rotate_2d(traj_rt[..., :2], base_ori[..., None]) + base_pos[..., None, :]
    h = wrap_angle(traj_rt[..., 2] + base_ori[..., None])
    return torch.cat([xy, h[..., None]], dim=-1)


@registry.register_loss(name="paired_mse_k")
def paired_mse_k(batch, output, config) -> Dict[str, torch.Tensor]:
    """Main training loss (reference: loss_func.py:404-488).

    output['motion_pred'] [R, B, N, K, S, D], output['motion_prob'] [R, B, N, K];
    batch.io_pairs.tgt [B, T, N, S, D] with T == R.
    """
    io = batch.io_pairs
    pred = output["motion_pred"].permute(1, 2, 0, 3, 4, 5)  # [B, N, T, K, S, D]
    prob = output["motion_prob"].permute(1, 2, 0, 3)        # [B, N, T, K]

    tgt = io.tgt.permute(0, 2, 1, 3, 4)                     # [B, N, T, S, D]
    tgt_valid = io.tgt_valid.permute(0, 2, 1, 3, 4)
    pair_mask = io.mask.permute(0, 2, 1)                    # [B, N, T]
    pair_mask = pair_mask & batch.prompt.mask[:, :, None]
    tgt_valid = tgt_valid & pair_mask[..., None, None]
    tgt = torch.where(tgt_valid, tgt, 0.0)

    results = {}
    full = torch.zeros((), device=pred.device)

    if config.LOSS.ROLLOUT_TRAJ.ENABLE:
        rollout_steps = config.ROLLOUT.POLICY.REPLAN_FREQ
        k_sel = prob.argmax(dim=-1)  # [B, N, T]
        pred_sel = _pick(pred, k_sel, 3)  # [B, N, T, S, Dp]

        B, N, T = pair_mask.shape
        gmm_params = None
        if config.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM:
            # motion_pred columns under PRED_GMM: [x, y, h, log_std1,
            # log_std2, rho, (xd, yd)] - gmm params feed the bivariate NLL
            # position term, vel moves to columns 6:8
            # (reference: loss_func.py:250-326 rollout_temp_traj_preds)
            gmm_params = pred_sel[..., :rollout_steps, 3:6].reshape(B, N, -1, 3)
            traj_cols = [pred_sel[..., :3]]
            if tgt.shape[-1] == 5:
                traj_cols.append(pred_sel[..., 6:8])
            pred_sel = torch.cat(traj_cols, dim=-1)
        pred_sel = torch.where(tgt_valid, pred_sel, 0.0)

        tgt_rt = rollout_traj(tgt, rollout_steps)
        pred_rt = rollout_traj(pred_sel, rollout_steps)

        step_valid = tgt_valid[..., :rollout_steps, :2].all(-1).reshape(B, N, -1)

        rloss, per_agent = compute_rollout_loss(
            tgt_rt, pred_rt, step_valid, config, gmm_params=gmm_params
        )
        results["rollout_pos_loss"] = rloss["pos"]
        results["rollout_head_loss"] = rloss["heading"]
        r_total = rloss["pos"] + rloss["heading"] * config.LOSS.ROLLOUT_TRAJ.HEAD_WEIGHT
        if "vel" in rloss:
            results["rollout_vel_loss"] = rloss["vel"]
            r_total = r_total + rloss["vel"] * config.LOSS.ROLLOUT_TRAJ.VEL_WEIGHT
        full = full + r_total * config.LOSS.ROLLOUT_TRAJ.WEIGHT

        results.update(condition_type_breakdown(batch, per_agent))

        rcfg = config.LOSS.ROLLOUT_TRAJ
        if rcfg.USE_OFFROAD_LOSS or rcfg.USE_COLLISION_LOSS:
            # scene-frame rollout: rotate each agent's t=0 local frame out
            base_pos = io.pos[:, 0]   # [B, N, 2]
            base_ori = io.ori[:, 0]   # [B, N]
            traj_s = _scene_frame(pred_rt, base_pos, base_ori)
            extents = io.extent[:, 0]
            agent_ok = per_agent["agent_valid"]

            if rcfg.USE_OFFROAD_LOSS and batch.road_edges is not None:
                from prosim_torch.train.safety_losses import offroad_loss, offroad_loss_centerline

                edges = batch.road_edges
                if config.DATASET.USE_WAYMO_ROAD_EDGE:
                    ol = offroad_loss(traj_s, extents, agent_ok, edges.pts, edges.nxt,
                                      edges.valid, t_sample=rcfg.OFFROAD_T_SAMPLE_RATE)
                else:
                    ol = offroad_loss_centerline(
                        traj_s, extents, agent_ok, edges.pts, edges.nxt, edges.valid,
                        t_sample=rcfg.OFFROAD_T_SAMPLE_RATE, margin=rcfg.OFFROAD_MARGIN,
                        gt_traj_xyh=_scene_frame(tgt_rt, base_pos, base_ori),
                    )
                results["rollout_offroad_loss"] = ol
                full = full + ol * rcfg.OFFROAD_WEIGHT

            if rcfg.USE_COLLISION_LOSS:
                from prosim_torch.train.safety_losses import collision_loss

                cl = collision_loss(
                    traj_s, extents, agent_ok,
                    agent_types=io.agent_type[:, 0],
                    k=rcfg.COLLISION_K,
                    t_sample=rcfg.COLLISION_T_SAMPLE_RATE,
                    threshold=rcfg.COLLISION_THRESHOLD,
                    vehicle_only=rcfg.COLLISION_VEHICLE_ONLY,
                    gt_traj_xyh=_scene_frame(tgt_rt, base_pos, base_ori),
                )
                results["rollout_collision_loss"] = cl
                full = full + cl * rcfg.COLLISION_WEIGHT
    else:
        sl, _ = step_loss_k_way(tgt, tgt_valid, pred, prob, config)
        results.update({k: v for k, v in sl.items() if k != "full_loss"})
        full = full + sl["full_loss"]

    if config.LOSS.GOAL_DIST_PRED.ENABLE and "goal_point" in output:
        gls = goal_prob_pred_loss(batch, output, config)
        results.update(gls)
        if "goal_dist_all" in gls:
            full = full + gls["goal_dist_all"] * config.LOSS.GOAL_DIST_PRED.WEIGHT

    if config.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS and "reconst_pred" in output:
        goal_losses = goal_recon_loss(batch, output, config)
        goal_all = torch.zeros((), device=pred.device)
        for k, v in goal_losses.items():
            if config.LOSS.ROLLOUT_TRAJ.GOAL_PRED_LOSS_COND_MASK and "uncond" in k:
                continue
            results[k] = v
            goal_all = goal_all + v
        results["goal_loss_all"] = goal_all
        full = full + goal_all * config.LOSS.ROLLOUT_TRAJ.GOAL_WEIGHT

    if config.LOSS.ROLLOUT_TRAJ.USE_PROMPT_LOSS and output.get("prompt_loss_aux") is not None:
        for k, v in output["prompt_loss_aux"].items():
            results[k] = v
            full = full + v * config.LOSS.ROLLOUT_TRAJ.PROMPT_WEIGHT

    results["full_loss"] = full
    return results


def _prompt_mask(c):
    return c["prompt_mask"] if isinstance(c, dict) else c.prompt_mask


def goal_recon_loss(batch, output, config):
    """MSE of the policy-embedding goal reconstruction against the GT goal at
    t=0, split into conditioned/unconditioned agents
    (reference: loss_func.py:524-554)."""
    recon = output["reconst_pred"]
    if recon.ndim == 4:  # [R, B, N, 2] -> step 0 == t = 0
        recon = recon[0]
    goal = batch.io_pairs.goal[:, 0]  # [B, N, 2]
    base_mask = batch.io_pairs.mask[:, 0] & batch.prompt.mask

    cond_mask = torch.zeros_like(base_mask)
    for key in ("goal_OneText", "motion_tag_OneText", "llm_text_OneText"):
        c = batch.conditions.get(key)
        if c is not None:
            cond_mask = cond_mask | _prompt_mask(c)

    out = {}
    for name, m in (("cond", base_mask & cond_mask), ("uncond", base_mask & ~cond_mask)):
        se = ((recon - goal) ** 2).sum(-1) / 2  # mean over the 2 coords
        out[f"{name}_goal"] = torch.where(m, se, 0.0).sum() / global_count(m)
    return out


def condition_type_breakdown(batch, per_agent):
    """Per-condition-type rollout-loss diagnostics
    (reference: loss_func.py:376-402). Detached metrics only."""
    out = {}
    if not batch.conditions:
        return out
    agent_valid = per_agent["agent_valid"]
    union = torch.zeros_like(agent_valid)
    masks = {}
    for ctype, c in batch.conditions.items():
        pm = _prompt_mask(c)
        union = union | pm
        masks[ctype] = pm & agent_valid
    masks["none"] = agent_valid & ~union
    for ctype, m in masks.items():
        denom = global_count(m)
        for lname in ("pos", "heading", "vel"):
            if lname in per_agent:
                val = torch.where(m, per_agent[lname], 0.0).sum() / denom
                out[f"conditional_{ctype}_rollout_{lname}_loss"] = val.detach()
    return out


loss_func_dict = {
    "paired_mse_k": paired_mse_k,
}


def gmm_nll(tgt_xy, pred_xy, gmm_params, log_std_range=(-1.609, 5.0), rho_limit=0.5):
    """Bivariate Gaussian NLL (MTR-style, reference: loss_func.py:37-75).

    tgt_xy/pred_xy [..., 2]; gmm_params [..., 3] = (log_std1, log_std2, rho).
    """
    res = tgt_xy - pred_xy
    dx, dy = res[..., 0], res[..., 1]
    log_std1 = gmm_params[..., 0].clamp(*log_std_range)
    log_std2 = gmm_params[..., 1].clamp(*log_std_range)
    std1, std2 = torch.exp(log_std1), torch.exp(log_std2)
    rho = gmm_params[..., 2].clamp(-rho_limit, rho_limit)
    log_coef = log_std1 + log_std2 + 0.5 * torch.log(1 - rho ** 2)
    expo = (0.5 / (1 - rho ** 2)) * (
        (dx / std1) ** 2 + (dy / std2) ** 2 - 2 * rho * dx * dy / (std1 * std2)
    )
    return log_coef + expo


def goal_prob_pred_loss(batch, output, config):
    """K-way goal distribution loss (reference: loss_func.py:556-607):
    cross-entropy toward the goal hypothesis nearest to GT + huber on that
    hypothesis + variance/entropy regularizers."""
    if "goal_point" not in output:
        return {}
    goal_point = output["goal_point"]   # [B, N, K, 2]
    goal_prob = output["goal_prob"]     # [B, N, K]
    gt = batch.io_pairs.goal[:, 0]      # [B, N, 2]
    mask = batch.io_pairs.mask[:, 0] & batch.prompt.mask

    dist = torch.linalg.vector_norm(goal_point - gt[:, :, None], dim=-1)  # [B, N, K]
    sel = dist.argmin(dim=-1)

    logp = torch.log_softmax(goal_prob, dim=-1)
    ce = -logp.gather(-1, sel[..., None])[..., 0]
    denom = global_count(mask)
    prob_loss = torch.where(mask, ce, 0.0).sum() / denom

    best = _pick(goal_point, sel, 2)
    delta = config.LOSS.TRAJ_CRITERION.HUBER_DELTA
    point = huber(best, gt, delta).mean(-1)
    point_loss = torch.where(mask, point, 0.0).sum() / denom

    # spread regularizer: keep hypotheses diverse. The variance is over the
    # K hypotheses, a quirk of the JAX package kept (inert at VAR_WEIGHT 0)
    var = goal_point.var(dim=2, unbiased=False).mean(-1)
    logvar = torch.log(torch.where(mask, var, 1.0) + 1e-6)
    neg_logvar = -(torch.where(mask, logvar, 0.0).sum() / denom)

    p = torch.softmax(goal_prob, dim=-1)
    ent = -(p * torch.log(p + 1e-6)).sum(-1)
    entropy = (torch.where(mask, ent, 0.0).sum() / denom).detach()

    # reference loss_func.py:602: point + CLS_WEIGHT * ce - VAR_WEIGHT * logvar
    full = (point_loss
            + prob_loss * config.LOSS.GOAL_DIST_PRED.CLS_WEIGHT
            + neg_logvar * config.LOSS.GOAL_DIST_PRED.VAR_WEIGHT)
    return {
        "goal_dist_prob_loss": prob_loss,
        "goal_dist_point_loss": point_loss,
        "goal_dist_neg_logvar": neg_logvar,
        "goal_dist_entropy": entropy,
        "goal_dist_all": full,
    }
