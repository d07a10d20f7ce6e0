"""Torch-Lightning checkpoint -> the port's parameters (port of
prosim_tpu/utils/checkpoint_convert.py).

The reference releases Lightning checkpoints whose state_dict keys follow its
module tree (reference: prosim/models/base.py:134-147 strips the frozen
llm_model while keeping LoRA). `convert_state_dict` is the JAX package's key
mapping, copied: it lays the keys out as the flax param tree of
prosim_tpu.models.prosim.ProSim, whose names the port's modules mirror, so
utils/params.py `flax_to_state_dict` carries the result onto the port's
`state_dict` (`reference_to_state_dict`). `load_reference_checkpoint` reads
a .ckpt and returns that state_dict with the keys left unmapped, and
`load_converted` merges it into a built ProSim non-strictly, as the
reference loads (strict=False): parameters the checkpoint lacks keep their
values, and converted keys the model lacks (modules the port does not
build, ROADMAP.md queue A4) are returned, never dropped silently.

Key mapping rules (torch -> flax):
  Linear  weight [out, in] -> kernel [in, out] (transposed), bias -> bias
  LayerNorm weight/bias    -> scale/bias
  Embedding weight         -> embedding
  MLP(nn.Sequential) index -> dense_i / norm_i by position
  scene_encoder.{a2a,s2s}_attn_layers.N.X -> scene_encoder/{a2a,s2s}_N/X
  AttentionLayer fields    -> prenorm_src/prenorm_dst/prenorm_r/to_q/.../ff_*
"""

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from prosim_torch.data.motion_tags import V2VTag, VActionTag
from prosim_torch.utils.params import flax_to_state_dict


def _mlp_index(seq_idx: int, without_norm: bool) -> Tuple[str, int]:
    """Sequential position -> (kind, layer index) for the reference MLP
    (reference: prosim/models/layers/mlp.py:475-494): pattern per hidden layer
    is Linear, [LayerNorm,] ReLU; final Linear [, ReLU]."""
    period = 2 if without_norm else 3
    layer, rem = divmod(seq_idx, period)
    if rem == 0:
        return "dense", layer
    if rem == 1 and not without_norm:
        return "norm", layer
    raise KeyError(f"sequential index {seq_idx} is an activation")


_ATTN_FIELD = {
    "attn_prenorm_x_src": "prenorm_src",
    "attn_prenorm_x_dst": "prenorm_dst",
    "attn_prenorm_r": "prenorm_r",
    "attn_postnorm": "postnorm",
    "ff_prenorm": "ff_prenorm",
    "ff_postnorm": "ff_postnorm",
    "to_q": "to_q",
    "to_k": "to_k",
    "to_v": "to_v",
    "to_k_r": "to_k_r",
    "to_v_r": "to_v_r",
    "to_s": "to_s",
    "to_g": "to_g",
    "to_out": "to_out",
    "ff_mlp.0": "ff_dense0",
    "ff_mlp.3": "ff_dense1",
}

_ATTN_STACKS = {
    "scene_encoder.a2a_attn_layers": ("scene_encoder", "a2a"),
    "scene_encoder.s2s_attn_layers": ("scene_encoder", "s2s"),
    "decoder.p2p_attn_layers": ("decoder", "p2p"),
    "decoder.s2p_attn_layers": ("decoder", "s2p"),
    "policy.act_decoder.a2p_attn_layers": ("policy", "a2p"),
    "policy.act_decoder.m2p_attn_layers": ("policy", "m2p"),
}

# non-bipartite stacks share one prenorm module for src and dst; torch
# state_dict still emits duplicate `attn_prenorm_x_dst.*` keys for the shared
# module (attention_layer.py:44-49) - those are dropped, the flax layer holds
# a single `prenorm_src`
_SHARED_DST_NORM = {"a2a", "s2s", "p2p", "cond_attn/layer"}

_POINTNETS = {
    "scene_encoder.map_encoder": ("scene_encoder", "map_encoder", "pointnet"),
    "scene_encoder.obs_encoder": ("scene_encoder", "obs_encoder", "pointnet"),
}

# learnable rel-PE FourierEmbedding sites (LEARNABLE_PE=True configs);
# reference names follow attn_fusion.py:25-29 / sym_coord.py:22-27 /
# act_decoder.py:181-186
_RELPE_SITES = {
    "scene_encoder.a2a_rel_pe_emb": ("scene_encoder", "a2a_pe"),
    "scene_encoder.s2s_rel_pe_emb": ("scene_encoder", "s2s_pe"),
    "decoder.p2p_rel_pe_emb": ("decoder", "p2p_pe"),
    "decoder.s2p_rel_pe_emb": ("decoder", "s2p_pe"),
    "policy.act_decoder.a2p_rel_pe_emb": ("policy", "a2p_pe"),
    "policy.act_decoder.m2p_rel_pe_emb": ("policy", "m2p_pe"),
}

# plain reference-MLP heads -> flax MLP path (without_norm flag)
# (reference: attn_fusion.py:19 obs_update_mlp, decoder/base.py:18-20 K-goal
# heads, act_decoder.py:36-56 context/aux heads)
_MLP_HEADS = {
    "scene_encoder.obs_update_mlp": (("scene_encoder", "obs_update_mlp"), False),
    "decoder.goal_prob_head": (("decoder", "goal_prob_head"), False),
    "decoder.goal_point_head": (("decoder", "goal_point_head"), False),
    "policy.act_decoder.goal_encoder": (("policy", "goal_encoder"), False),
    "policy.act_decoder.context_fuse": (("policy", "context_fuse"), False),
    "policy.act_decoder.vel_head": (("policy", "vel_head"), False),
    "policy.act_decoder.goal_head": (("policy", "goal_head"), False),
    "policy.act_decoder.cluster_mlp": (("policy", "cluster_mlp"), False),
    "prompt_encoder.motion_pred.state_encoder": (
        ("prompt_encoder", "state_encoder"), False),
    "policy.act_decoder.motion_head": (("policy", "motion_head"), False),
    "policy.act_decoder.pred_mlp": (("policy", "pred_mlp"), False),
}


def _map_fourier_key(rest: str):
    """Reference learnable FourierEmbedding key -> (flax sub, leaf, kind)
    (reference: fourier_embedding.py:11-34: freqs Embedding, per-dim
    Sequential(Linear, LN, ReLU, Linear), to_out Sequential(LN, ReLU, Linear))."""
    if rest == "freqs.weight":
        return "freqs", None, "raw"
    m = re.match(r"mlps\.(\d+)\.(0|1|3)\.(weight|bias)$", rest)
    if m:
        i, pos, leaf = m.groups()
        sub = {"0": f"mlp_{i}_dense0", "1": f"mlp_{i}_norm", "3": f"mlp_{i}_dense1"}[pos]
        return sub, leaf, ("norm" if pos == "1" else "linear")
    m = re.match(r"to_out\.(0|2)\.(weight|bias)$", rest)
    if m:
        pos, leaf = m.groups()
        sub = "out_norm" if pos == "0" else "out_dense"
        return sub, leaf, ("norm" if pos == "0" else "linear")
    return None


def _convert_tensor(name: str, value: np.ndarray, is_linear: bool):
    if name == "weight":
        if is_linear and value.ndim == 2:
            return "kernel", value.T
        return "scale", value  # LayerNorm
    if name == "bias":
        return "bias", value
    if name == "weight_embedding":
        return "embedding", value
    return name, value


def _put(tree: dict, path: Tuple[str, ...], leaf_name: str, value: np.ndarray,
         kind: str):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    new_name, new_val = _convert_tensor(leaf_name, value, is_linear=(kind == "linear"))
    node[new_name] = np.asarray(new_val)


def _map_mlp_key(rest: str, without_norm: bool = False) -> Optional[Tuple[str, str]]:
    """'mlp.3.weight' -> ('dense_1', 'weight')."""
    m = re.match(r"mlp\.(\d+)\.(weight|bias)$", rest)
    if not m:
        return None
    kind, layer = _mlp_index(int(m.group(1)), without_norm)
    return f"{kind}_{layer}", m.group(2)


def convert_state_dict(sd: Dict[str, np.ndarray],
                       strict: bool = False) -> Tuple[dict, list]:
    """Map a reference ProSim state_dict into the flax params tree layout.

    Returns (params, unmapped_keys). Keys under the frozen LLM body are
    expected to be absent (on_save_checkpoint strips them); LoRA keys map to
    the JAX Llama LoRA leaves.
    """
    params: dict = {}
    unmapped = []
    tag_rows: dict = {}  # (path, enum_size) -> {row: vector}

    def put_mlp(path, rest, value, without_norm=False):
        hit = _map_mlp_key(rest, without_norm=without_norm)
        if hit is None:
            return False
        sub, leaf = hit
        _put(params, path + (sub,), leaf, value,
             "linear" if "dense" in sub else "norm")
        return True

    for key, value in sd.items():
        value = np.asarray(value)
        mapped = False

        # attention stacks (incl. GNN condition attention, resolved below)
        stack_hits = list(_ATTN_STACKS.items()) + [
            (m.group(0).rsplit(".attn_layers", 1)[0] + ".attn_layers",
             (f"condition_transformer_{m.group(1)}", "cond_attn/layer"))
            for m in [re.match(
                r"condition_transformers\.(\w+)\.condition_attn\.attn_layers", key
            )] if m
        ]
        for prefix, target in stack_hits:
            m = re.match(rf"{re.escape(prefix)}\.(\d+)\.(.+)\.(weight|bias)$", key)
            if not m:
                continue
            idx, field, leaf = m.group(1), m.group(2), m.group(3)
            if field not in _ATTN_FIELD:
                break
            flax_field = _ATTN_FIELD[field]
            is_linear = flax_field.startswith(("to_", "ff_dense"))
            top, short = target
            if flax_field == "prenorm_dst" and short in _SHARED_DST_NORM:
                mapped = True  # duplicate of prenorm_src; consumed
                break
            if short == "cond_attn/layer":
                path = (top, "cond_attn", f"layer_{idx}", flax_field)
            else:
                path = (top, f"{short}_{idx}", flax_field)
            _put(params, path, leaf, value,
                 "linear" if is_linear else "norm")
            mapped = True
            break
        if mapped:
            continue

        # pointnet encoders (scene + drag-point condition)
        pn_sites = dict(_POINTNETS)
        m = re.match(
            r"condition_transformers\.(\w+)\.condition_encoders\.drag_point"
            r"\.pointnet_encoder\.", key
        )
        if m:
            pn_sites[key[: m.end() - 1]] = (
                f"condition_transformer_{m.group(1)}", "encoders_drag_point",
                "pointnet",
            )
        for prefix, path in pn_sites.items():
            m = re.match(
                rf"{re.escape(prefix)}\.(pre_mlps|mlps|out_mlps)\.(.+)$", key
            )
            if not m:
                continue
            block, rest = m.group(1), m.group(2)
            if put_mlp(path + (block,), rest,
                       value, without_norm=(block == "out_mlps")):
                mapped = True
            break
        if mapped:
            continue

        # plain MLP heads
        for prefix, (path, wn) in _MLP_HEADS.items():
            m = re.match(rf"{re.escape(prefix)}\.(.+)$", key)
            if m and put_mlp(path, m.group(1), value, without_norm=wn):
                mapped = True
                break
        if mapped:
            continue

        # learnable rel-PE Fourier embeddings
        for prefix, path in _RELPE_SITES.items():
            m = re.match(rf"{re.escape(prefix)}\.(.+)$", key)
            if not m:
                continue
            hit = _map_fourier_key(m.group(1))
            if hit is None:
                break
            sub, leaf, kind = hit
            if leaf is None:  # freqs embedding table, layout identical
                node = params
                for p in path + ("fourier",):
                    node = node.setdefault(p, {})
                node[sub] = np.asarray(value)
            else:
                _put(params, path + ("fourier", sub), leaf, value, kind)
            mapped = True
            break
        if mapped:
            continue

        if key == "policy.act_decoder.motion_anchors.weight":
            _put(params, ("policy", "motion_anchors"), "weight_embedding", value, "embed")
            continue
        m = re.match(r"policy\.act_decoder\.(CG_decode|CG_fuse)\.CGs\.(\d+)\.MLP\.(0|1)\.(weight|bias)$", key)
        if m:
            name, idx, pos, leaf = m.groups()
            flax_name = "cg_decode" if name == "CG_decode" else "cg_fuse"
            sub = "dense" if pos == "0" else "norm"
            _put(params, ("policy", flax_name, f"block_{idx}", sub), leaf, value,
                 "linear" if sub == "dense" else "norm")
            continue

        # --- condition encoders: goal MLP + motion-tag parameter banks ---
        m = re.match(
            r"condition_transformers\.(\w+)\.condition_encoders\.goal"
            r"\.goal_encoder\.(.+)$", key
        )
        if m:
            # reference goal MLP is without_norm (condition_encoders.py:19)
            if put_mlp(
                (f"condition_transformer_{m.group(1)}", "encoders_goal",
                 "goal_encoder"),
                m.group(2), value, without_norm=True,
            ):
                continue
        m = re.match(
            r"condition_transformers\.(\w+)\.condition_encoders"
            r"\.(v_action_tag|v2v_tag)\.tag_encoder\.(\w+)$", key
        )
        if m:
            # per-tag nn.Parameter -> row of the tag bank, indexed by the tag
            # ENUM VALUE (reference: condition_encoders.py:70-72 ParameterDict)
            loc, ctype, tag = m.groups()
            enum = V2VTag if ctype == "v2v_tag" else VActionTag
            if tag in enum.__members__:
                path = (f"condition_transformer_{loc}", f"encoders_{ctype}")
                tag_rows.setdefault((path, len(enum)), {})[enum[tag].value] = value
                continue
        m = re.match(
            r"condition_transformers\.(\w+)\.condition_attn\.cond_type_emds"
            r"\.weight$", key
        )
        if m:
            # dead parameter: only read by unregistered attn variants
            # (condition_attns.py:25,52-58 _obtain_cond_batch is not on the
            # GNN path) - consumed here so strict conversion stays clean
            continue

        # --- text/LLM subsystem (text_attns.py:63-74 projections; peft LoRA
        # keys kept by on_save_checkpoint, models/base.py:134-139) ---
        m = re.match(
            r"condition_transformers\.(\w+)\.text_attn\.(.+)$", key
        )
        if m:
            loc, rest = m.group(1), m.group(2)
            base = (f"condition_transformer_{loc}", "text_attn")
            hit = None
            for torch_name, flax_name, wn in (
                ("prompt_to_llm", "prompt_to_llm", False),
                ("llm_to_cond", "llm_to_cond", False),
                ("prompt_mask_pred", "mask_pred_head", True),
            ):
                mm = re.match(rf"{torch_name}\.(.+)$", rest)
                if mm:
                    hit = _map_mlp_key(mm.group(1), without_norm=wn)
                    if hit:
                        sub, leaf = hit
                        _put(params, base + (flax_name, sub), leaf, value,
                             "linear" if "dense" in sub else "norm")
                    break
            if hit:
                continue
            mm = re.match(r"ln_prompt\.(weight|bias)$", rest)
            if mm:
                _put(params, base + ("ln_prompt",), mm.group(1), value, "norm")
                continue
            # peft LoRA: lora_A [r, in] / lora_B [out, r] -> lora_a [in, r] /
            # lora_b [r, out]
            mm = re.match(
                r"llm_model\.(?:base_model\.model\.)?model\.layers\.(\d+)\."
                r"self_attn\.([qkv]_proj)\.lora_(A|B)\.(?:default\.)?weight$",
                rest,
            )
            if mm:
                layer, proj, ab = mm.groups()
                leaf = "lora_a" if ab == "A" else "lora_b"
                _put(params, base + ("llm", f"layer_{layer}", proj),
                     leaf, value.T, "raw")
                continue
            mm = re.match(
                r"llm_model\.(?:base_model\.model\.)?model\.embed_tokens\."
                r"lora_embedding_(A|B)(?:\.default)?$",
                rest,
            )
            if mm:
                # peft embedding LoRA: A [r, V], B [H, r] -> [V, r] / [r, H]
                leaf = "lora_embed_a" if mm.group(1) == "A" else "lora_embed_b"
                _put(params, base + ("llm",), leaf, value.T, "raw")
                continue

        unmapped.append(key)

    # assemble tag banks: zeros for tags absent from the checkpoint (they are
    # never selected when USED_TAGS excludes them)
    for (path, n_rows), rows in tag_rows.items():
        dim = len(next(iter(rows.values())))
        bank = np.zeros((n_rows, dim), np.float32)
        for r, v in rows.items():
            bank[r] = v
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node["tag_params"] = bank

    if strict and unmapped:
        raise KeyError(f"unmapped checkpoint keys: {unmapped[:10]} (+{len(unmapped)-10 if len(unmapped)>10 else 0})")
    return params, unmapped


def reference_to_state_dict(sd: Dict[str, np.ndarray],
                            strict: bool = False) -> Tuple[Dict[str, np.ndarray], list]:
    """A reference state_dict -> ({the port's parameter name: array},
    unmapped keys)."""
    params, unmapped = convert_state_dict(sd, strict=strict)
    return flax_to_state_dict(params), unmapped


def load_reference_checkpoint(path: str, strict: bool = False):
    """Load a torch Lightning .ckpt on the host and convert its state_dict:
    (the port's state_dict as arrays, unmapped keys). bf16 tensors are
    read as f32."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    np_sd = {k: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach()).numpy()
             if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}
    return reference_to_state_dict(np_sd, strict=strict)


@torch.no_grad()
def load_converted(model: torch.nn.Module, state_dict: Dict[str, np.ndarray]) -> list:
    """Non-strict merge of a converted state_dict into `model` (the
    reference loads strict=False, models/base.py:141-147): each key the
    model has is copied into it, on its device and in its dtype, and must
    fit its shape exactly; parameters the checkpoint lacks keep their
    values. Returns the keys the model lacks."""
    own = model.state_dict()
    missing = [k for k in state_dict if k not in own]
    for k, v in state_dict.items():
        if k in own:
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"{k}: checkpoint shape {v.shape}, model {tuple(own[k].shape)}")
            own[k].copy_(torch.from_numpy(v))
    return missing
