"""The weight bridge: JAX package variables -> this port's `state_dict`.

The port's modules carry the reference checkpoint's torch names, the keys
that `mvsformer_tpu/utils/convert_weights.py` (`convert_full_twin`,
`convert_twins`, `convert_full_dino`, `convert_dino_vit`) reads. This
module is the inverse of those converters: it
takes the JAX `{"params", "batch_stats"}` trees as nested dicts of numpy
arrays and lays each tensor out for torch:

- flax conv kernel [k..., I, O] -> torch [O, I, k...] (depthwise: I = 1);
- flax ConvTranspose kernel [k..., in, out], spatially flipped -> torch
  [in, out, k...];
- flax Dense kernel [I, O] -> torch Linear weight [O, I] (qkv keeps its
  [q; k; v] packing);
- LayerNorm / BN / GroupNorm scale -> weight; BN mean / var ->
  running_mean / running_var (GN and IN have no running statistics, so a
  model without BN has no `batch_stats`, and any missing subtree of it
  reads as empty);
- StageNet: `vis` only under cnn fusion, `attn_temp` under epipoleV2; the
  U-Nets of a stage without `vis` (epipole's CostRegNet2D, epipoleV2's
  CostRegNet3D) have the `Sequential` transposed-conv keys.

Each `*_state` function maps one module's subtree; `convert_flax_twin` maps
the whole TwinMVSNet, `convert_flax_dino` the whole DINOMVSNet, and
`convert_flax` either, by the tree. The variants are read from the tree
too: the multi-scale FPN (`decoder/upsample1`) and Twins decoder
(`decoder_vit/decoder1`), the DINO decoders (`decoder_vit/decoder1a`:
`VITDecoderStage4`, under the flax modules' names, since the reference
names of these two are not in the repository; `down_sample`:
`VITDecoderStage4NoAtt`) and a ViT's cross blocks (`cross_block{k}`). `load_reference_checkpoint` loads a
reference `.pth` of either model as it is, since the names already agree,
and `merge_pretrained_backbone` merges a pretrained Twins or DINO ViT
`.pth` into the backbone.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv_w(k):
    k = np.asarray(k)
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd) + tuple(range(nd)))


def _deconv_w(k):
    k = np.asarray(k)
    nd = k.ndim - 2
    k = k[(slice(None, None, -1),) * nd]
    return np.moveaxis(k, (nd, nd + 1), (0, 1))


def _bn(sd, key, p, s):
    sd[f"{key}.weight"] = p["scale"]
    sd[f"{key}.bias"] = p["bias"]
    sd[f"{key}.running_mean"] = s["mean"]
    sd[f"{key}.running_var"] = s["var"]
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _sub(tree, *keys):
    """tree[k0][k1]..., or {} where a key is missing (a `batch_stats` tree
    has no entry for a block without BN)."""
    for k in keys:
        tree = tree.get(k, {})
    return tree


def _conv_block(sd, key, p, s, conv_key="conv", bn_key="bn", deconv=False):
    """flax <block>/{Conv_0|ConvTranspose_0} + Norm_0/{BatchNorm_0 |
    GroupNorm_0 | nothing} -> torch <key>.<conv_key>.* + <key>.<bn_key>.*"""
    layer = p["ConvTranspose_0" if deconv else "Conv_0"]
    sd[f"{key}.{conv_key}.weight"] = (_deconv_w if deconv else _conv_w)(layer["kernel"])
    if "bias" in layer:
        sd[f"{key}.{conv_key}.bias"] = layer["bias"]
    norm = p.get("Norm_0", {})
    if "BatchNorm_0" in norm:
        _bn(sd, f"{key}.{bn_key}", norm["BatchNorm_0"], _sub(s, "Norm_0", "BatchNorm_0"))
    elif "GroupNorm_0" in norm:
        _ln(sd, f"{key}.{bn_key}", norm["GroupNorm_0"])


def _plain(sd, key, p, transform=_conv_w):
    sd[f"{key}.weight"] = transform(p["kernel"])
    if "bias" in p:
        sd[f"{key}.bias"] = p["bias"]


def _ln(sd, key, p):
    sd[f"{key}.weight"] = p["scale"]
    sd[f"{key}.bias"] = p["bias"]


ENCODER_BLOCKS = ("conv00", "conv01", "downsample1", "conv10", "conv11",
                  "downsample2", "conv20", "conv21", "downsample3", "conv30", "conv31")


def encoder_state(params, stats, prefix="") -> dict:
    sd: dict = {}
    for name in ENCODER_BLOCKS:
        _conv_block(sd, f"{prefix}{name}", params[name], _sub(stats, name))
    return sd


def _norm(sd, key, params, stats, name):
    """A flax `Norm` module `name` (BatchNorm_0, GroupNorm_0, or no
    parameters under "none") -> torch <key>.*"""
    norm = params.get(name, {})
    if "BatchNorm_0" in norm:
        _bn(sd, key, norm["BatchNorm_0"], _sub(stats, name, "BatchNorm_0"))
    elif "GroupNorm_0" in norm:
        _ln(sd, key, norm["GroupNorm_0"])


def fpn_decoder_state(params, stats, prefix="") -> dict:
    """FPNDecoder, or FPNDecoderV2 (multi-scale) where the tree has
    `upsample1`."""
    sd: dict = {}
    if "upsample1" in params:
        for k in (1, 2, 3, 4):
            _conv_block(sd, f"{prefix}out{k}", params[f"out{k}"], _sub(stats, f"out{k}"),
                        conv_key="0", bn_key="1")
        for k in (1, 2, 3):
            _conv_block(sd, f"{prefix}upsample{k}", params[f"upsample{k}"],
                        _sub(stats, f"upsample{k}"), conv_key="0", bn_key="1", deconv=True)
        return sd
    for k in range(4):
        _conv_block(sd, f"{prefix}out{k}", params[f"out{k}"], _sub(stats, f"out{k}"),
                    conv_key="0", bn_key="1")
    for k in (1, 2, 3):
        _plain(sd, f"{prefix}inner{k}", params[f"inner{k}"])
    return sd


def twin_decoder_state(params, stats, prefix="") -> dict:
    """TwinDecoderStage4, or TwinDecoderStage4V2 (its `decoder1` and
    `decoder2` too)."""
    sd: dict = {}
    for name in ("upsampler0", "decoder1", "decoder2"):
        if name in params:
            _conv_block(sd, f"{prefix}{name}", params[name], _sub(stats, name),
                        conv_key="0", bn_key="1", deconv=True)
    for k in (1, 2, 3):
        _plain(sd, f"{prefix}inner{k}", params[f"inner{k}"])
        _conv_block(sd, f"{prefix}smooth{k}", params[f"smooth{k}"], _sub(stats, f"smooth{k}"),
                    conv_key="0", bn_key="1")
    return sd


def twins_state(params, depths=(2, 2, 10, 4), prefix="") -> dict:
    """flax ALTGVT params -> torch ALTGVT keys (the inverse of convert_twins)."""
    sd: dict = {}
    for i, depth in enumerate(depths):
        pe = params[f"patch_embed{i}"]
        _plain(sd, f"{prefix}patch_embeds.{i}.proj", pe["proj"])
        _ln(sd, f"{prefix}patch_embeds.{i}.norm", pe["norm"])
        _plain(sd, f"{prefix}pos_block.{i}.proj.0", params[f"pos_block{i}"]["proj"])
        _ln(sd, f"{prefix}norm_list.{i}", params[f"stage_norm{i}"])
        for j in range(depth):
            blk = params[f"block{i}_{j}"]
            key = f"{prefix}blocks.{i}.{j}"
            _ln(sd, f"{key}.norm1", blk["norm1"])
            _ln(sd, f"{key}.norm2", blk["norm2"])
            _plain(sd, f"{key}.mlp.fc1", blk["mlp"]["fc1"], np.transpose)
            _plain(sd, f"{key}.mlp.fc2", blk["mlp"]["fc2"], np.transpose)
            attn = blk["attn"]
            for name in ("qkv", "q", "kv", "proj"):
                if name in attn:
                    _plain(sd, f"{key}.attn.{name}", attn[name], np.transpose)
            if "sr" in attn:
                _plain(sd, f"{key}.attn.sr", attn["sr"])
                _ln(sd, f"{key}.attn.norm", attn["norm"])
    return sd


def cross_block_state(params, prefix="") -> dict:
    """flax CrossBlock params -> torch keys (the flax modules' names)."""
    sd: dict = {f"{prefix}tok_embeddings.weight": params["tok_embeddings"]["embedding"],
                f"{prefix}alpha1": params["alpha1"], f"{prefix}alpha2": params["alpha2"]}
    for name in ("attn.qkv", "attn.proj", "fc1", "fc2"):
        _plain(sd, f"{prefix}{name}", _sub(params, *name.split(".")), np.transpose)
    return sd


def dino_vit_state(params, depth=12, prefix="") -> dict:
    """flax DINOViT params -> torch DINO ViT keys (the inverse of
    convert_dino_vit), with its cross blocks where it has them."""
    sd: dict = {f"{prefix}cls_token": params["cls_token"],
                f"{prefix}pos_embed": params["pos_embed"]}
    _plain(sd, f"{prefix}patch_embed.proj", params["patch_embed"])
    _ln(sd, f"{prefix}norm", params["norm"])
    for i in range(depth):
        blk, key = params[f"block{i}"], f"{prefix}blocks.{i}"
        _ln(sd, f"{key}.norm1", blk["norm1"])
        _ln(sd, f"{key}.norm2", blk["norm2"])
        _plain(sd, f"{key}.attn.qkv", blk["attn"]["qkv"], np.transpose)
        _plain(sd, f"{key}.attn.proj", blk["attn"]["proj"], np.transpose)
        _plain(sd, f"{key}.mlp.fc1", blk["fc1"], np.transpose)
        _plain(sd, f"{key}.mlp.fc2", blk["fc2"], np.transpose)
    for name in params:
        if name.startswith("cross_block"):
            sd.update(cross_block_state(params[name], f"{prefix}{name}."))
    return sd


def vit_decoder_state(params, stats, prefix="") -> dict:
    """flax VITDecoderStage4Single -> torch keys (the DINO decoder part of
    convert_full_dino): the attention fusion, then the two transposed
    convs at `decoder.0/1` and `decoder.3/4`. VITDecoderStage4 (the tree
    has `decoder1a`) and VITDecoderStage4NoAtt (`down_sample`) keep the
    flax names."""
    sd: dict = {}
    if "down_sample" in params:
        for name, deconv in (("down_sample", False), ("deconv1", True), ("deconv2", True)):
            _conv_block(sd, f"{prefix}{name}", params[name], _sub(stats, name), conv_key="0",
                        bn_key="1", deconv=deconv)
        return sd
    for name in ("conv_l", "conv_r"):
        _conv_block(sd, f"{prefix}attn.{name}", params["attn"][name], _sub(stats, "attn", name),
                    conv_key="0", bn_key="1")
    _plain(sd, f"{prefix}attn.proj", params["attn"]["proj"])
    if "decoder1a" in params:
        _conv_block(sd, f"{prefix}decoder1a", params["decoder1a"], _sub(stats, "decoder1a"),
                    conv_key="0", bn_key="1", deconv=True)
        for name in ("decoder1b", "decoder2", "decoder3"):
            _plain(sd, f"{prefix}{name}", params[name], _deconv_w)
        for name in ("bn2", "bn3"):
            _norm(sd, f"{prefix}{name}", params, stats, name)
        return sd
    for name, keys in (("deconv1", ("0", "1")), ("deconv2", ("3", "4"))):
        _conv_block(sd, f"{prefix}decoder", params[name], _sub(stats, name), conv_key=keys[0],
                    bn_key=keys[1], deconv=True)
    return sd


def cost_reg_state(params, stats, three_d: bool, prefix="") -> dict:
    """CostRegNet (three_d=False), or CostRegNet3D or CostRegNet2D
    (three_d=True: their transposed convs are `Sequential`s)."""
    sd: dict = {}
    for n in (1, 2, 3, 4, 5, 6):
        _conv_block(sd, f"{prefix}conv{n}", params[f"conv{n}"], _sub(stats, f"conv{n}"))
    for n in (7, 9, 11):
        keys = dict(conv_key="0", bn_key="1") if three_d else {}
        _conv_block(sd, f"{prefix}conv{n}", params[f"conv{n}"], _sub(stats, f"conv{n}"),
                    deconv=True, **keys)
    if "inner" in params:
        _plain(sd, f"{prefix}inner", params["inner"])
    _plain(sd, f"{prefix}prob", params["prob"])
    return sd


def vis_state(params, stats, prefix="") -> dict:
    sd: dict = {}
    for j in (0, 1, 2):
        _conv_block(sd, f"{prefix}{j}", params[f"conv{j}"], _sub(stats, f"conv{j}"))
    _plain(sd, f"{prefix}3", params["conv3"])
    return sd


def to_torch(sd: dict) -> dict:
    """Copies, so read-only arrays (a JAX array's numpy view) are taken too;
    a 0-d array (epipoleV2's `attn_temp`) stays 0-d."""
    return {k: torch.tensor(np.array(v)) for k, v in sd.items()}


def _cascade_state(params, batch_stats, ndepths, model_th) -> dict:
    """The parts both models share: the FPN and the stages."""
    sd: dict = {}
    sd.update(encoder_state(params["encoder"], _sub(batch_stats, "encoder"), "encoder."))
    sd.update(fpn_decoder_state(params["decoder"], _sub(batch_stats, "decoder"), "decoder."))
    for i, nd in enumerate(ndepths):
        p, s = params[f"stage{i + 1}"], _sub(batch_stats, f"stage{i + 1}")
        if "vis" in p:
            sd.update(vis_state(p["vis"], _sub(s, "vis"), f"fusions.{i}.vis."))
        if "attn_temp" in p:
            sd[f"fusions.{i}.attn_temp"] = p["attn_temp"]
        sd.update(cost_reg_state(p["cost_reg"], _sub(s, "cost_reg"),
                                 "vis" not in p or nd <= model_th, f"fusions.{i}.cost_reg."))
    return sd


def convert_flax_twin(params, batch_stats, ndepths=(32, 16, 8, 4), model_th=8,
                      vit_depths=(2, 2, 10, 4)) -> dict:
    """JAX TwinMVSNet variables -> the port's TwinMVSNet `state_dict`."""
    sd = _cascade_state(params, batch_stats, ndepths, model_th)
    sd.update(twin_decoder_state(params["decoder_vit"], _sub(batch_stats, "decoder_vit"),
                                 "decoder_vit."))
    sd.update(twins_state(params["vit"], vit_depths, "vit."))
    return to_torch(sd)


def convert_flax_dino(params, batch_stats, ndepths=(32, 16, 8, 4), model_th=8,
                      vit_depth=12) -> dict:
    """JAX DINOMVSNet variables -> the port's DINOMVSNet `state_dict`."""
    sd = _cascade_state(params, batch_stats, ndepths, model_th)
    sd.update(vit_decoder_state(params["decoder_vit"], _sub(batch_stats, "decoder_vit"),
                                "decoder_vit."))
    sd.update(dino_vit_state(params["vit"], vit_depth, "vit."))
    return to_torch(sd)


def convert_flax(params, batch_stats, ndepths=(32, 16, 8, 4), model_th=8,
                 vit_depths=(2, 2, 10, 4)) -> dict:
    """Either model's JAX variables -> the port's `state_dict`: DINOMVSNet's
    where the backbone has a `cls_token` (its depth counted from the tree),
    else TwinMVSNet's with the Twins stage depths `vit_depths`."""
    vit = params["vit"]
    if "cls_token" in vit:
        depth = sum(1 for k in vit if k.startswith("block"))
        return convert_flax_dino(params, batch_stats, ndepths, model_th, depth)
    return convert_flax_twin(params, batch_stats, ndepths, model_th, vit_depths)


def load_flax_twin(model, params, batch_stats) -> None:
    """Load JAX TwinMVSNet variables into the port's model (strict)."""
    cfg = model.cfg
    sd = convert_flax_twin(params, batch_stats, tuple(cfg.ndepths), cfg.model_th,
                           tuple(len(b) for b in model.vit.blocks))
    model.load_state_dict(sd, strict=True)


def load_flax_dino(model, params, batch_stats) -> None:
    """Load JAX DINOMVSNet variables into the port's model (strict)."""
    cfg = model.cfg
    sd = convert_flax_dino(params, batch_stats, tuple(cfg.ndepths), cfg.model_th,
                           len(model.vit.blocks))
    model.load_state_dict(sd, strict=True)


BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def convert_flax_grads(grads, batch_stats, ndepths=(32, 16, 8, 4), model_th=8,
                       vit_depths=(2, 2, 10, 4)) -> tuple[dict, dict]:
    """A JAX gradient tree (the shape of `params`, of either model) and its
    `batch_stats` -> ({parameter name: gradient}, {buffer name: running
    statistic}) in the port's names. Every layout change of the bridge is a
    transpose or a flip, which is linear, so a gradient maps exactly as its
    weight does."""
    sd = convert_flax(grads, batch_stats, ndepths, model_th, vit_depths)
    params = {k: v for k, v in sd.items() if not k.endswith(BUFFER_SUFFIXES)}
    buffers = {k: v for k, v in sd.items()
               if k.endswith(BUFFER_SUFFIXES) and not k.endswith(".num_batches_tracked")}
    return params, buffers


def load_reference_checkpoint(path: str, model) -> None:
    """Load a reference MVSFormer or MVSFormer-P checkpoint (a torch `.pth`
    holding {'state_dict': ...} or the state dict itself; a `module.`
    prefix, as DataParallel saves it, is stripped) into the port's
    TwinMVSNet or DINOMVSNet. The port's modules carry the reference's
    names, so the load is strict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


def merge_pretrained_backbone(model, path: str, prefix: str = "vit.", log=print) -> dict:
    """Merge a pretrained backbone checkpoint into the model's `prefix`
    tensors, non-strictly, as the reference's `torch_init_model` does at
    model construction: tensors present in both with the same shape are
    copied; missing, unexpected and shape-mismatched names are reported
    through `log` (the JAX package's report). The file may hold the state
    dict itself, {'model': sd}, or {'state_dict': sd} whose `vit.` names
    are the backbone's. Returns {loaded, missing, unexpected, mismatched}
    (sorted names)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
        if any(k.startswith("vit.") for k in sd):
            sd = {k[len("vit."):]: v for k, v in sd.items() if k.startswith("vit.")}
    elif isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        sd = obj["model"]
    else:
        sd = obj
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    want = {k[len(prefix):]: v for k, v in model.state_dict().items() if k.startswith(prefix)}
    if not want:
        raise KeyError(f"the model has no '{prefix}' tensors")
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    mismatched = sorted(k for k in set(want) & set(sd)
                        if tuple(want[k].shape) != tuple(sd[k].shape))
    loaded = sorted((set(want) & set(sd)) - set(mismatched))
    log(f"[pretrained] {path} -> {prefix.rstrip('.')}: loaded {len(loaded)}/{len(want)} "
        f"tensors; missing {len(missing)}, unexpected {len(unexpected)}, "
        f"shape-mismatch {len(mismatched)}")
    for name, keys in (("missing", missing), ("unexpected", unexpected),
                       ("shape-mismatch", mismatched)):
        for k in keys[:20]:
            log(f"[pretrained]   {name}: {k}")
        if len(keys) > 20:
            log(f"[pretrained]   ... and {len(keys) - 20} more {name}")
    with torch.no_grad():
        for k in loaded:
            want[k].copy_(sd[k])
    return {"loaded": loaded, "missing": missing, "unexpected": unexpected,
            "mismatched": mismatched}
