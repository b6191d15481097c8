"""The bridge from a SAM configuration file (`cfg["arch"] == "sam"`) to the
program and the reference: the program's config objects and network, the
seeded weights, the box prompts, the reference's frame pipeline and the
step's count.

Weights (`make_weights`): one `torch.rand` call on the device draws every
parameter of `reference/sam.param_specs`, each a slice scaled by kind:
linear and conv weights uniform with variance 1 / fan-in, biases uniform in
+-BIAS, norm weights 1 +- NORM and their biases +-NORM; `pos_embed`
uniform with unit variance; every rel-pos table uniform with variance
REL_POS / head width, so that q . R is as large as a score q . k / sqrt(d)
(SAM starts pos_embed and the tables at zero, which would hide a fault in
the bias or the position); the embeddings, tokens and the Fourier matrix
standard normal, as nn.Embedding and SAM's PositionEmbeddingRandom draw
them. No calibration: every block is normed, so activations keep their
scale through the depth.

Boxes (`box_pool`): per prompt a centre uniform over the frame and sides
log-uniform in BOX_SIDES pixels, the box clipped to the frame, xyxy
float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import counts, traffic
from benchmark.harness.weights import seed63
from benchmark.reference import sam as ref

BIAS, NORM, REL_POS = 0.1, 0.1, 1.0
BOX_SIDES = (32.0, 640.0)


def spec(cfg: dict):
    """The program's SAMSpec holding every width of `cfg`."""
    from xrseg_tpu_torch.models import sam
    if cfg["iou_head_hidden_dim"] != cfg["prompt_embed_dim"] or \
            cfg["num_multimask_outputs"] != 3:
        raise ValueError("the program's decoder has build_sam.py's IoU head "
                         "(hidden width = prompt_embed_dim) and 4 masks")
    return sam.SAMSpec(
        embed_dim=cfg["encoder_embed_dim"], depth=cfg["encoder_depth"],
        num_heads=cfg["encoder_num_heads"],
        global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]),
        img_size=cfg["image_size"], patch_size=cfg["vit_patch_size"],
        window_size=cfg["window_size"], mlp_ratio=cfg["mlp_ratio"],
        prompt_dim=cfg["prompt_embed_dim"],
        decoder_depth=cfg["decoder_depth"],
        decoder_heads=cfg["decoder_num_heads"],
        decoder_mlp_dim=cfg["decoder_mlp_dim"],
        attention_downsample=cfg["attention_downsample_rate"],
        iou_head_depth=cfg["iou_head_depth"])


def model_config(cfg: dict):
    from xrseg_tpu_torch.config import ModelConfig
    S = cfg["image_size"]
    return ModelConfig(arch="sam", scale=cfg["scale"], input_size=(S, S),
                       dtype=cfg["dtype"], param_dtype=cfg["param_dtype"],
                       matmul_precision=cfg.get("matmul_precision",
                                                "default"))


def exec_config(cfg: dict):
    from xrseg_tpu_torch.config import ExecutorConfig
    return ExecutorConfig(model=model_config(cfg))


def build_model(cfg: dict, sd, device):
    """The program's SAM for `cfg` on `device`, holding a copy of `sd` (a
    strict load)."""
    from xrseg_tpu_torch.models import sam
    with torch.device(device):
        model = sam.SAM(model_config(cfg), spec(cfg))
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The module docstring's draw of every parameter, float32 on
    `device`."""
    specs = ref.param_specs(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed63(seed))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    pool = torch.rand(total, generator=gen, device=dev).mul_(2).sub_(1)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        t = pool[off:off + n].view(shape)
        off += n
        if kind in ("linear", "conv"):
            t.mul_(math.sqrt(3.0 / math.prod(shape[1:])))
        elif kind == "up":
            t.mul_(math.sqrt(3.0 / shape[0]))
        elif kind == "bias":
            t.mul_(BIAS)
        elif kind == "norm":
            t.mul_(NORM).add_(1.0)
        elif kind == "norm_bias":
            t.mul_(NORM)
        elif kind == "pos":
            t.mul_(math.sqrt(3.0))
        elif kind == "relpos":
            t.mul_(math.sqrt(3.0 * REL_POS / shape[1]))
        elif kind in ("embed", "gauss"):
            t = torch.randn(shape, generator=gen, device=dev)
        else:
            raise ValueError(f"{name}: no draw for kind {kind!r}")
        sd[name] = t
    return sd


def box_pool(seed: int, n_batches: int, batch: int, prompts: int,
             frame_hw) -> List[np.ndarray]:
    """`n_batches` seeded box sets [batch, prompts, 4] (xyxy float32,
    frame pixels; the module docstring's draw)."""
    H, W = frame_hw
    rng = traffic.rng_for(seed, 6)
    shape = (n_batches, batch, prompts)
    lo, hi = np.log(BOX_SIDES[0]), np.log(BOX_SIDES[1])
    w, h = np.exp(rng.uniform(lo, hi, shape)), np.exp(rng.uniform(lo, hi,
                                                                  shape))
    cx, cy = rng.uniform(0, W, shape), rng.uniform(0, H, shape)
    boxes = np.stack([np.clip(cx - w / 2, 0, W), np.clip(cy - h / 2, 0, H),
                      np.clip(cx + w / 2, 0, W), np.clip(cy + h / 2, 0, H)],
                     -1).astype(np.float32)
    return list(boxes)


def pipeline_run(sd: Dict[str, torch.Tensor], cfg: dict, frames, boxes,
                 device, quant: Optional[str] = None
                 ) -> Dict[str, torch.Tensor]:
    """The reference's answer to one batch (numpy frames [B, H, W, 3] and
    boxes [B, P, 4]) on `device`, mask 0 of each prompt: low_res [B, P,
    4g, 4g], iou [B, P], frame_logits [B, P, H, W]; float32 tensors there.
    `quant` rounds every product's operands (yolo.fake_quant)."""
    out = ref.run(sd, cfg, torch.as_tensor(np.asarray(frames)).to(device),
                  torch.as_tensor(np.asarray(boxes)).to(device), quant=quant)
    return {"low_res": out["masks"][:, :, 0], "iou": out["iou"][:, :, 0],
            "frame_logits": out["frame_logits"]}


def pipeline_counts(cfg: dict, batch: int, prompts: int) -> Dict[str, float]:
    """FLOPs and least time (seconds) of one step of `batch` frames with
    `prompts` boxes each: the forward's layers (reference/sam.py's count,
    each the larger of FLOPs over the peak and bytes over the bandwidth),
    the preprocess (a uint8 frame read, the bf16 input written) and the
    masks (the bf16 low-resolution logits read, the packed row written:
    IoU and logits in float32, the frame-size masks in bytes); and
    relpos_least_s, the least time of the encoder's rel-pos attention
    calls alone."""
    fwd = ref.count_forward(cfg, batch, prompts)
    lt = counts.least_time
    least = sum(lt(f, bi + bw + bo) for _, f, bi, bw, bo in fwd.layers)
    relpos = sum(lt(f, bi + bw + bo) for kind, f, bi, bw, bo in fwd.layers
                 if kind == "relpos_attention")
    fh, fw = cfg["frame_hw"]
    S = cfg["image_size"]
    lr = 4 * S // cfg["vit_patch_size"]
    least += lt(0, batch * (fh * fw * 3 + S * S * 3 * 2))
    n = batch * prompts
    least += lt(0, n * (lr * lr * 2 + 4 + lr * lr * 4 + fh * fw))
    return {"flops": float(fwd.flops), "least_s": least,
            "relpos_least_s": relpos}


def config_numbers(cfg: dict) -> Dict[str, float]:
    """The configuration file's `counted`: parameters (millions), the
    encoder's GFLOPs a frame and those of its attention products (the
    rel-pos attention's four), and the decoder's GFLOPs a prompt."""
    n_params = sum(math.prod(s) for _, s, _ in ref.param_specs(cfg))
    one = ref.count_forward(cfg, 1, 1)
    two = ref.count_forward(cfg, 1, 2)
    dec = two.flops - one.flops
    attn = sum(f for kind, f, *_ in one.layers if kind == "relpos_attention")
    return {"params_m": n_params / 1e6,
            "encoder_gflops_per_frame": (one.flops - dec) / 1e9,
            "attention_gflops_per_frame": attn / 1e9,
            "decoder_gflops_per_prompt": dec / 1e9}
