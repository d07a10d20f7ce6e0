"""A reference ProSim state_dict with random values, synthesised from a
config: the keys and shapes of the reference's Lightning module tree
(reference: prosim/models/traj_sam.py:49-52, layers/mlp.py:475-494,
attention_layer.py:13-55, condition_transformer/*, peft LoRA keys kept by
models/base.py:134-139 on_save_checkpoint), in numpy alone.

No released checkpoint is in the repository; this stands in for one in the
converter's tests (tests/test_torch_weights.py) and in chip_smoke.py's
serve phase, which puts tests/ on its path for it. It imports numpy and
the port alone. `reference_state_dict` covers what the port builds for a
config, the 'mlp' obs-update fusion, the goal context and every policy head
among it; it refuses the MLP map and obs encoders, whose keys the
converter does not map. `ref_mlp_sd` and friends add keys of any other
module.
"""

import numpy as np

from prosim_torch.data.motion_tags import V2VTag, VActionTag
from prosim_torch.data.synthetic import map_feature_dim, obs_feature_dim
from prosim_torch.models.condition.transformer import _resolve_llm_config


def ref_mlp_sd(prefix, dims, rng, without_norm=False):
    """Reference MLP keys (mlp.py:475-494): per hidden layer Linear
    [, LayerNorm] ReLU, then the last Linear; torch Linear weight [out, in]."""
    sd, pos = {}, 0
    n = len(dims) - 1
    for i in range(n):
        sd[f"{prefix}.mlp.{pos}.weight"] = rng.normal(size=(dims[i + 1], dims[i]))
        sd[f"{prefix}.mlp.{pos}.bias"] = rng.normal(size=(dims[i + 1],))
        pos += 1
        if i < n - 1:
            if not without_norm:
                sd[f"{prefix}.mlp.{pos}.weight"] = rng.normal(size=(dims[i + 1],))
                sd[f"{prefix}.mlp.{pos}.bias"] = rng.normal(size=(dims[i + 1],))
                pos += 1
            pos += 1  # ReLU
    return sd


def ref_attn_sd(prefix, H, heads, hd, rng):
    """Reference AttentionLayer keys (attention_layer.py:13-55). A
    non-bipartite layer shares its src/dst prenorm, but its state_dict
    still names both."""
    inner = heads * hd
    sd = {}
    lin = {"to_q": (inner, H, True), "to_k": (inner, H, False),
           "to_v": (inner, H, True), "to_k_r": (inner, H, False),
           "to_v_r": (inner, H, True), "to_s": (inner, H, True),
           "to_g": (inner, inner + H, True), "to_out": (H, inner, True)}
    for name, (o, i, bias) in lin.items():
        sd[f"{prefix}.{name}.weight"] = rng.normal(size=(o, i))
        if bias:
            sd[f"{prefix}.{name}.bias"] = rng.normal(size=(o,))
    sd[f"{prefix}.ff_mlp.0.weight"] = rng.normal(size=(4 * H, H))
    sd[f"{prefix}.ff_mlp.0.bias"] = rng.normal(size=(4 * H,))
    sd[f"{prefix}.ff_mlp.3.weight"] = rng.normal(size=(H, 4 * H))
    sd[f"{prefix}.ff_mlp.3.bias"] = rng.normal(size=(H,))
    for n in ("attn_prenorm_x_src", "attn_prenorm_x_dst", "attn_prenorm_r",
              "attn_postnorm", "ff_prenorm", "ff_postnorm"):
        sd[f"{prefix}.{n}.weight"] = rng.normal(size=(H,))
        sd[f"{prefix}.{n}.bias"] = rng.normal(size=(H,))
    return sd


def ref_pointnet_sd(prefix, in_dim, H, rng, npre=1, nmlp=3):
    sd = {}
    sd.update(ref_mlp_sd(f"{prefix}.pre_mlps", [in_dim] + [H] * npre, rng))
    sd.update(ref_mlp_sd(f"{prefix}.mlps", [2 * H] + [H] * (nmlp - npre), rng))
    sd.update(ref_mlp_sd(f"{prefix}.out_mlps", [H, H, H], rng, without_norm=True))
    return sd


def _stack(prefix, attn, H, rng):
    sd = {}
    for i in range(attn.NUM_LAYER):
        sd.update(ref_attn_sd(f"{prefix}.{i}", H, attn.NUM_HEAD, attn.FF_DIM, rng))
    return sd


def reference_state_dict(config, seed: int = 0) -> dict:
    """{reference key: float32 array} for the architecture of `config`,
    every value N(0, 1) from np.random.default_rng(seed). The frozen Llama
    body is absent, as in a released checkpoint; its LoRA leaves are there."""
    mc = config.MODEL
    H = mc.HIDDEN_DIM
    if "mlp" in (mc.SCENE_ENCODER.MAP_TYPE, mc.SCENE_ENCODER.OBS_TYPE):
        raise ValueError("the converter maps no keys of the MLP map/obs encoders")
    rng = np.random.default_rng(seed)
    sd = {}
    for name, enc, in_dim in (("map", mc.MAP_ENCODER, map_feature_dim(config)),
                              ("obs", mc.OBS_ENCODER, obs_feature_dim(config))):
        sd.update(ref_pointnet_sd(f"scene_encoder.{name}_encoder", in_dim, H, rng,
                                  enc.POINTNET.NUM_PRE_LAYERS, enc.POINTNET.NUM_MLP_LAYERS))
    se, de, ad = mc.SCENE_ENCODER.ATTN, mc.DECODER.ATTN, mc.POLICY.ACT_DECODER
    sd.update(_stack("scene_encoder.a2a_attn_layers", se, H, rng))
    sd.update(_stack("scene_encoder.s2s_attn_layers", se, H, rng))
    sd.update(_stack("decoder.p2p_attn_layers", de, H, rng))
    sd.update(_stack("decoder.s2p_attn_layers", de, H, rng))
    sd.update(_stack("policy.act_decoder.a2p_attn_layers", ad.ATTN, H, rng))
    sd.update(_stack("policy.act_decoder.m2p_attn_layers", ad.ATTN, H, rng))
    if mc.DECODER.GOAL_PRED.ENABLE:
        K = mc.DECODER.GOAL_PRED.K
        sd.update(ref_mlp_sd("decoder.goal_prob_head", [H, H // 2, K], rng))
        sd.update(ref_mlp_sd("decoder.goal_point_head", [H, H // 2, K * 2], rng))

    status = config.PROMPT.AGENT_STATUS
    in_dim = 2 * status.USE_VEL + 2 * status.USE_EXTEND + 3 * status.USE_AGENT_TYPE
    sd.update(ref_mlp_sd("prompt_encoder.motion_pred.state_encoder", [in_dim, H, H], rng))

    if mc.OBS_UPDATE.FUSION == "mlp":
        sd.update(ref_mlp_sd("scene_encoder.obs_update_mlp", [2 * H, H, H], rng))
    if ad.CONTEXT.GOAL:
        sd.update(ref_mlp_sd("policy.act_decoder.goal_encoder",
                             [H if ad.CONTEXT.USE_POSE_EMB else 2, H], rng))
        if ad.CONTEXT.EMD:
            sd.update(ref_mlp_sd("policy.act_decoder.context_fuse", [2 * H, H], rng))

    fmt = config.DATASET.FORMAT
    state_dim = len(fmt.TARGET.ELEMENTS.split(",")) + 3 * ad.TRAJ.PRED_GMM
    out_dim = fmt.TARGET.STEPS * state_dim
    mode = ad.TRAJ.PRED_MODE
    heads = {"vel_pred": ("vel_head", [H, H, H // 2, 2]), "goal_pred": ("goal_head", [H, 3]),
             "mlp": ("motion_head", [H, H, H // 2, ad.TRAJ.K * out_dim])}
    name, dims = heads.get(mode, ("motion_head", [H, H, H // 2, out_dim]))
    sd.update(ref_mlp_sd(f"policy.act_decoder.{name}", dims, rng))
    if config.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS:
        sd.update(ref_mlp_sd("policy.act_decoder.pred_mlp", [H, H, H // 2, 2], rng))
    if mode in ("anchor", "cluster"):
        if mode == "cluster":
            sd.update(ref_mlp_sd("policy.act_decoder.cluster_mlp", [H, H], rng))
        else:
            n_types = 3 if config.DATASET.USE_PED_CYCLIST else 1
            sd["policy.act_decoder.motion_anchors.weight"] = rng.normal(
                size=(ad.TRAJ.K * n_types, H))
        for i in range(3):
            p = f"policy.act_decoder.CG_decode.CGs.{i}.MLP"
            sd[f"{p}.0.weight"] = rng.normal(size=(H, H))
            sd[f"{p}.0.bias"] = rng.normal(size=(H,))
            sd[f"{p}.1.weight"] = rng.normal(size=(H,))
            sd[f"{p}.1.bias"] = rng.normal(size=(H,))

    types = list(config.PROMPT.CONDITION.TYPES)
    ct = mc.CONDITION_TRANSFORMER
    for loc in (ct.CONDITION_LOCATIONS if types else []):
        sd.update(_condition_transformer_sd(config, f"condition_transformers.{loc}", types, H, rng))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _condition_transformer_sd(config, pre, types, H, rng):
    ct = config.MODEL.CONDITION_TRANSFORMER
    sd = {}
    if "goal" in types:
        sd.update(ref_mlp_sd(f"{pre}.condition_encoders.goal.goal_encoder", [2, H, H], rng,
                             without_norm=True))
    if "drag_point" in types:
        dp = ct.CONDITION_ENCODER.DRAG_POINTS
        sd.update(ref_pointnet_sd(f"{pre}.condition_encoders.drag_point.pointnet_encoder", 2, H,
                                  rng, dp.NUM_PRE_LAYERS, dp.NUM_MLP_LAYERS))
    if "v_action_tag" in types:
        for tag in config.PROMPT.CONDITION.MOTION_TAG.USED_TAGS:
            if tag in VActionTag.__members__:
                sd[f"{pre}.condition_encoders.v_action_tag.tag_encoder.{tag}"] = (
                    rng.normal(size=(H,)))
    if "v2v_tag" in types:
        for tag in config.PROMPT.CONDITION.MOTION_TAG.USED_TAGS:
            if tag in V2VTag.__members__:
                sd[f"{pre}.condition_encoders.v2v_tag.tag_encoder.{tag}"] = (
                    rng.normal(size=(2 * H,)))
    non_text = [t for t in types if "OneText" not in t]
    if non_text:
        for i in range(ct.NLAYER):
            sd.update(ref_attn_sd(f"{pre}.condition_attn.attn_layers.{i}", H, ct.NHEAD,
                                  ct.FF_DIM, rng))
        sd[f"{pre}.condition_attn.cond_type_emds.weight"] = rng.normal(size=(len(types), H))
    if len(non_text) < len(types) and ct.TEXT_ATTN.TYPE == "llama":
        llm = ct.CONDITION_ENCODER.TEXT.LLM
        lora = ct.TEXT_ATTN.LORA
        r = lora.R if lora.ENABLE else 0
        lc = _resolve_llm_config(llm.ARCH, llm.WEIGHTS_PATH, r)
        LH, ta = lc.hidden_size, f"{pre}.text_attn"
        sd.update(ref_mlp_sd(f"{ta}.prompt_to_llm", [H, H, LH], rng))
        sd.update(ref_mlp_sd(f"{ta}.llm_to_cond", [LH, H, H], rng))
        sd[f"{ta}.ln_prompt.weight"] = rng.normal(size=(LH,))
        sd[f"{ta}.ln_prompt.bias"] = rng.normal(size=(LH,))
        if llm.PROMPT_LOSS.PROMPT_MASK_PRED:
            sd.update(ref_mlp_sd(f"{ta}.prompt_mask_pred", [H, 1], rng, without_norm=True))
        lp = f"{ta}.llm_model.base_model.model.model"
        kv = lc.num_kv_heads * lc.head_dim
        for layer in range(lc.num_layers if r else 0):
            for proj, od in (("q_proj", lc.num_heads * lc.head_dim), ("k_proj", kv),
                             ("v_proj", kv)):
                p = f"{lp}.layers.{layer}.self_attn.{proj}"
                sd[f"{p}.lora_A.default.weight"] = rng.normal(size=(r, LH))
                sd[f"{p}.lora_B.default.weight"] = rng.normal(size=(od, r))
        if r:
            sd[f"{lp}.embed_tokens.lora_embedding_A.default"] = rng.normal(
                size=(r, lc.total_vocab))
            sd[f"{lp}.embed_tokens.lora_embedding_B.default"] = rng.normal(size=(LH, r))
    return sd
