"""SAM ViT-B (`models.sam.SamModel`) and its serving path against the
benchmark's plain reference (`benchmark/reference/sam_vitb_c4.py`), on the
CPU at a small size: 64 px, patch 8 (an 8 x 8 grid), windows of 3 (so the
grid is padded to 9 x 9), one windowed and one global block of 3 heads of
16, a 32-wide decoder of 2 heads, and a 3-layer C4 GCNN, on weights drawn
from a seed by the benchmark's own `data.make_weights`.

Bars, fp32: 2e-5 of the largest value for a part, 5e-5 for the served
pipeline. Both sides compute the same products in fp32; only the order of
some sums differs (the GCNN's banks built another way, batched against
per-image calls), which moves float32 by a few units in the 7th digit
(measured: the parts 0, the pipeline's masks and IoU 3.5e-7 to 9.3e-7).
bf16: the serving build against the fp32 reference under 0.1 of the
largest mask logit, where the bf16 program reads 0.014-0.023 on this
file's batches and the fp8 control (the reference one precision below)
0.22-0.31.

SAM ViT-B's full-size state dict is written out in this file from SAM's
module tree (`segment_anything/modeling`), not read from the port, and
loads with strict=True.
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check, data  # noqa: E402
from benchmark.harness.segment import make_boxes  # noqa: E402
from benchmark.reference import sam_vitb_c4 as ref  # noqa: E402
from benchmark.reference.common import Precision, fp32_only  # noqa: E402
from equiadapt_tpu_torch.cli.segmentation_serve import build_serving_pipeline  # noqa: E402
from equiadapt_tpu_torch.models.sam import SamModel  # noqa: E402
from equiadapt_tpu_torch.pipelines.segmentation import ImageSegmentationPipeline  # noqa: E402
from equiadapt_tpu_torch.utils import profiling  # noqa: E402
from equiadapt_tpu_torch.utils.config import Config  # noqa: E402
from equiadapt_tpu_torch.utils.registry import (  # noqa: E402
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_segmentation_prediction_network,
)
from torch_port_cpu import one_intra_op_thread  # noqa: E402, F401

SEED = 2 ** 33 + 21
SIZE, B, N = 64, 3, 3
PART_BAR = 2e-5  # fp32 against fp32, a part (module docstring)
PIPE_BAR = 5e-5  # fp32 against fp32, the served pipeline
BF16_BAR = 0.1   # the bf16 serving build's mask logits against fp32


def _settings():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "sam-vitb-c4.json").read_text())
    s = copy.deepcopy(cfg["settings"])
    s["dataset"]["image_size"] = SIZE
    s["canonicalization"]["network_hyperparams"].update(num_layers=3, out_channels=4)
    s["canonicalization"]["resize_shape"] = 32
    s["sam"] = {"encoder": {"patch_size": 8, "embed_dim": 48, "depth": 2, "num_heads": 3,
                            "window_size": 3, "global_attn_indexes": [1], "mlp_ratio": 4.0},
                "prompt_dim": 32, "decoder_depth": 2, "decoder_heads": 2, "decoder_mlp": 64,
                "num_mask_tokens": 4, "iou_hidden": 32}
    return s


S = _settings()


@pytest.fixture(autouse=True)
def _fp32():
    fp32_only()


@pytest.fixture(scope="module")
def weights():
    return data.make_weights(ref.param_spec(S), SEED, "cpu")


def _sam(weights, dtype=torch.float32) -> SamModel:
    m = SamModel(image_size=SIZE, **S["sam"], dtype=dtype, device="cpu")
    pre = ref.PRED + "."
    m.load_state_dict({k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)},
                      strict=True)
    return m


def _pipeline(weights) -> ImageSegmentationPipeline:
    """The fp32 pipeline: the configuration's canonicalizer without its
    bf16 casts, and SAM in fp32."""
    cfg = Config.from_dict(S).override("canonicalization.compute_dtype=null",
                                       "canonicalization.output_dtype=null")
    shape = (SIZE, SIZE, 3)
    net = get_image_canonicalization_network(cfg.canonicalization, shape, device="cpu")
    canon = get_image_canonicalizer(cfg.canonicalization, net, shape, device="cpu")
    pipe = ImageSegmentationPipeline(canon, _sam(weights))
    data.load_weights(pipe, weights)
    return pipe


def _inputs(i=0):
    gen = data.generator(SEED, f"pool{i}", "cpu")
    return (data.smooth_images(gen, B, SIZE),
            make_boxes(SEED, i, B, N, SIZE, 4.0, 48.0, "cpu"))


def _rel(a, b):
    return check.rel_max(a, b)


@pytest.mark.parametrize("i", [0, 1], ids=["windowed", "global"])
def test_encoder_block(weights, i):
    m = _sam(weights)
    h = torch.randn(2, 8, 8, 48, generator=torch.Generator().manual_seed(i))
    with torch.no_grad():
        assert _rel(m.image_encoder.blocks[i](h), ref.block(weights, h, i, S)) < PART_BAR
        x = _inputs()[0]
        assert _rel(m.image_encoder(x), ref.encode(weights, x, S)) < PART_BAR


def test_prompt_encoder(weights):
    m = _sam(weights)
    boxes = _inputs()[1]
    with torch.no_grad():
        got = m.prompt_encoder(boxes, (SIZE, SIZE))
        for b in range(B):
            assert _rel(got[b], ref.prompt_tokens(weights, boxes[b], SIZE)) < PART_BAR
        pe = m.prompt_encoder.dense_pe().reshape(64, -1)
        assert _rel(pe, ref.grid_pe(weights, 8, "cpu")) < PART_BAR


def test_two_way_transformer(weights):
    m = _sam(weights)
    g = torch.Generator().manual_seed(5)
    tokens, src, pe = (torch.randn(4, 7, 32, generator=g), torch.randn(4, 64, 32, generator=g),
                       torch.randn(4, 64, 32, generator=g))
    with torch.no_grad():
        q, k = m.mask_decoder.transformer(tokens, src, pe)
        rq, rk = ref.two_way(weights, tokens, src, pe, S)
    assert _rel(q, rq) < PART_BAR and _rel(k, rk) < PART_BAR


def test_mask_decoder(weights):
    m = _sam(weights)
    x, boxes = _inputs()
    with torch.no_grad():
        emb = m.image_encoder(x)
        sparse = m.prompt_encoder(boxes, (SIZE, SIZE))
        low, iou = m.mask_decoder(emb, m.prompt_encoder.dense_pe(), sparse,
                                  m.prompt_encoder.no_mask_embed.weight[0])
        for b in range(B):
            rlow, riou = ref.decode(weights, emb[b], ref.prompt_tokens(weights, boxes[b], SIZE),
                                    S)
            assert _rel(low[b], rlow) < PART_BAR and _rel(iou[b], riou) < PART_BAR


def test_served_pipeline_fp32(weights):
    pipe = _pipeline(weights)
    x, boxes = _inputs()
    with torch.no_grad():
        masks, iou, info = pipe.serve(x, boxes)
        canonical, _, _ = pipe.canonicalizer(x, {"boxes": boxes})
        out = ref.serve(weights, x, boxes, S)
    assert torch.equal(info.element.rotation_deg, out["element"])
    assert set(out["element"].tolist()) != {0.0}, "the seed turns some image"
    assert ref.element_gaps(out, out["element"], info.group_activations)["energy_err"] < PIPE_BAR
    assert _rel(canonical, out["canonical"]) < PIPE_BAR
    assert masks.shape == (B, N, SIZE, SIZE) and iou.shape == (B, N)
    assert _rel(masks, out["masks"]) < PIPE_BAR and _rel(iou, out["iou"]) < PIPE_BAR


@pytest.mark.parametrize("fault", ["no_rel_pos", "windowed_global"])
def test_planted_faults_exceed_the_fp32_bar(weights, fault):
    """A path that leaves out the relative-position bias, or windows the
    global blocks, reads far over the fp32 bar."""
    x, boxes = _inputs()
    with torch.no_grad():
        out = ref.serve(weights, x, boxes, S)
        bad = ref.serve(weights, x, boxes, S, follow=out["element"], faults=(fault,))
    assert _rel(bad["masks"], out["masks"]) > 100 * PIPE_BAR


def test_bf16_serving_under_a_bar_the_fp8_control_exceeds(weights):
    pipe = build_serving_pipeline(Config.from_dict(S), "cpu", **S["sam"])
    data.load_weights(pipe, weights)
    assert pipe.prediction_network.dtype == torch.bfloat16
    x, boxes = _inputs(1)
    with torch.no_grad():
        masks, iou, info = pipe.serve(x, boxes)
        el = info.element.rotation_deg
        out = ref.serve(weights, x, boxes, S, follow=el)
        ctrl = ref.serve(weights, x, boxes, S, follow=el, prec=Precision("fp8"))
    assert masks.dtype == iou.dtype == torch.float32
    assert _rel(masks, out["masks"]) < BF16_BAR
    assert _rel(ctrl["masks"], out["masks"]) > BF16_BAR


def test_quarter_turn_equivariance(weights):
    """Images and boxes turned by 90 degrees give the same masks turned:
    the canonicalizer picks the turned element, so SAM sees the same
    canonical image and boxes."""
    pipe = _pipeline(weights)
    x, boxes = _inputs()
    turned = torch.rot90(x, 1, dims=(1, 2))
    turned_boxes = ref.turn_boxes(boxes, torch.full((B,), -1), SIZE)
    with torch.no_grad():
        masks, iou, info = pipe.serve(x, boxes)
        masks_t, iou_t, info_t = pipe.serve(turned, turned_boxes)
    assert torch.equal((info_t.element.rotation_deg - info.element.rotation_deg) % 360,
                       torch.full((B,), 90.0))
    assert _rel(masks_t, torch.rot90(masks, 1, dims=(2, 3))) < PIPE_BAR
    assert _rel(iou_t, iou) < PIPE_BAR


def test_box_only_targets():
    """A served request's boxes are canonicalized without masks, as with
    them; targets without boxes raise."""
    cfg = Config.from_dict(S).override("canonicalization.compute_dtype=null",
                                       "canonicalization.output_dtype=null")
    shape = (SIZE, SIZE, 3)
    canon = get_image_canonicalizer(cfg.canonicalization, get_image_canonicalization_network(
        cfg.canonicalization, shape, device="cpu"), shape, device="cpu")
    x, boxes = _inputs()
    masks = torch.zeros(B, N, SIZE, SIZE)
    with torch.no_grad():
        xc, tc, info = canon(x, {"boxes": boxes})
        xc2, tc2, _ = canon(x, {"boxes": boxes, "masks": masks})
    assert set(tc) == {"boxes"} and torch.equal(tc["boxes"], tc2["boxes"])
    assert torch.equal(xc, xc2)
    with pytest.raises(KeyError):
        canon(x, {"masks": masks})


def test_spans_and_counters(weights):
    pipe = _pipeline(weights)
    x, boxes = _inputs()
    before = profiling.counters()
    with torch.no_grad(), profiling.recording() as session:
        pipe.serve(x, boxes)
    after = profiling.counters()
    rows = session.summary()
    for span in ("pipeline", "canon", "predict", "sam/encoder", "sam/attn/window",
                 "sam/attn/global", "sam/neck", "sam/prompt", "sam/decoder", "sam/upsample",
                 "canon/invert"):
        assert span in rows, span
    assert rows["sam/attn/window"]["calls"] == rows["sam/attn/global"]["calls"] == 1
    assert after.get("sam/prompts", 0) - before.get("sam/prompts", 0) == B * N
    # windowed: 9 windows of 3 x 3 a grid; global: 8 x 8; decoder: 7 tokens
    # (self 7 x 7, both ways 7 x 64 and 64 x 7, final 7 x 64) of 2 heads
    enc = B * 9 * 3 * 9 ** 2 + B * 3 * 64 ** 2
    dec = B * N * 2 * (2 * 7 * 7 + 2 * (2 * 7 * 64) + 7 * 64)
    assert (after.get("sam/attn_score_elems", 0) - before.get("sam/attn_score_elems", 0)
            == enc + dec)


def _sam_vit_b_state_shapes():
    """Every tensor of SAM ViT-B's state dict (`build_sam_vit_b`), written
    out from SAM's module tree."""
    D, depth, heads, mlp, P, M, T = 768, 12, 12, 3072, 256, 2048, 4
    out = {"image_encoder.pos_embed": (1, 64, 64, D),
           "image_encoder.patch_embed.proj.weight": (D, 3, 16, 16),
           "image_encoder.patch_embed.proj.bias": (D,)}
    for i in range(depth):
        b = f"image_encoder.blocks.{i}"
        side = 64 if i in (2, 5, 8, 11) else 14
        out.update({f"{b}.norm1.weight": (D,), f"{b}.norm1.bias": (D,),
                    f"{b}.attn.qkv.weight": (3 * D, D), f"{b}.attn.qkv.bias": (3 * D,),
                    f"{b}.attn.proj.weight": (D, D), f"{b}.attn.proj.bias": (D,),
                    f"{b}.attn.rel_pos_h": (2 * side - 1, D // heads),
                    f"{b}.attn.rel_pos_w": (2 * side - 1, D // heads),
                    f"{b}.norm2.weight": (D,), f"{b}.norm2.bias": (D,),
                    f"{b}.mlp.lin1.weight": (mlp, D), f"{b}.mlp.lin1.bias": (mlp,),
                    f"{b}.mlp.lin2.weight": (D, mlp), f"{b}.mlp.lin2.bias": (D,)})
    out.update({"image_encoder.neck.0.weight": (P, D, 1, 1), "image_encoder.neck.1.weight": (P,),
                "image_encoder.neck.1.bias": (P,), "image_encoder.neck.2.weight": (P, P, 3, 3),
                "image_encoder.neck.3.weight": (P,), "image_encoder.neck.3.bias": (P,)})
    pe = "prompt_encoder"
    out[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = (2, P // 2)
    for j in range(4):
        out[f"{pe}.point_embeddings.{j}.weight"] = (1, P)
    out.update({f"{pe}.not_a_point_embed.weight": (1, P), f"{pe}.no_mask_embed.weight": (1, P),
                f"{pe}.mask_downscaling.0.weight": (4, 1, 2, 2),
                f"{pe}.mask_downscaling.0.bias": (4,), f"{pe}.mask_downscaling.1.weight": (4,),
                f"{pe}.mask_downscaling.1.bias": (4,),
                f"{pe}.mask_downscaling.3.weight": (16, 4, 2, 2),
                f"{pe}.mask_downscaling.3.bias": (16,), f"{pe}.mask_downscaling.4.weight": (16,),
                f"{pe}.mask_downscaling.4.bias": (16,),
                f"{pe}.mask_downscaling.6.weight": (P, 16, 1, 1),
                f"{pe}.mask_downscaling.6.bias": (P,)})

    def attention(prefix, inner):
        for n in ("q_proj", "k_proj", "v_proj"):
            out[f"{prefix}.{n}.weight"], out[f"{prefix}.{n}.bias"] = (inner, P), (inner,)
        out[f"{prefix}.out_proj.weight"], out[f"{prefix}.out_proj.bias"] = (P, inner), (P,)

    def norm(prefix, ch):
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = (ch,), (ch,)

    def linear(prefix, o, i):
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = (o, i), (o,)

    tr = "mask_decoder.transformer"
    for i in range(2):
        lp = f"{tr}.layers.{i}"
        attention(f"{lp}.self_attn", P)
        attention(f"{lp}.cross_attn_token_to_image", P // 2)
        attention(f"{lp}.cross_attn_image_to_token", P // 2)
        linear(f"{lp}.mlp.lin1", M, P)
        linear(f"{lp}.mlp.lin2", P, M)
        for n in range(1, 5):
            norm(f"{lp}.norm{n}", P)
    attention(f"{tr}.final_attn_token_to_image", P // 2)
    norm(f"{tr}.norm_final_attn", P)
    out["mask_decoder.iou_token.weight"] = (1, P)
    out["mask_decoder.mask_tokens.weight"] = (T, P)
    out["mask_decoder.output_upscaling.0.weight"] = (P, P // 4, 2, 2)
    out["mask_decoder.output_upscaling.0.bias"] = (P // 4,)
    norm("mask_decoder.output_upscaling.1", P // 4)
    out["mask_decoder.output_upscaling.3.weight"] = (P // 4, P // 8, 2, 2)
    out["mask_decoder.output_upscaling.3.bias"] = (P // 8,)
    for t in range(T):
        for li, (o, i) in enumerate(((P, P), (P, P), (P // 8, P))):
            linear(f"mask_decoder.output_hypernetworks_mlps.{t}.layers.{li}", o, i)
    for li, (o, i) in enumerate(((256, P), (256, 256), (T, 256))):
        linear(f"mask_decoder.iou_prediction_head.layers.{li}", o, i)
    return out


def test_sam_vit_b_published_widths_load_strict():
    m = get_segmentation_prediction_network("sam_vit_b", 1024, device="meta")
    shapes = _sam_vit_b_state_shapes()
    assert len(shapes) == 314
    sd = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    m.load_state_dict(sd, strict=True)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == shapes
    enc, dec = m.image_encoder, m.mask_decoder
    assert [b.window_size for b in enc.blocks] == [0 if i in (2, 5, 8, 11) else 14
                                                   for i in range(12)]
    attn = enc.blocks[0].attn
    assert (attn.num_heads, attn.head_dim, enc.blocks[0].mlp.lin1.out_features) == (12, 64, 3072)
    layer = dec.transformer.layers[0]
    assert (layer.self_attn.heads, layer.mlp.lin1.out_features) == (8, 2048)
    assert layer.cross_attn_token_to_image.q_proj.out_features == 128  # downsample 2
    assert dec.num_mask_tokens == 4
    assert sum(v.numel() for v in sd.values()) == sum(p.numel() for p in m.parameters()) + 256


def test_serving_cli_prints_the_spans(tmp_path, capsys):
    """`cli.segmentation_serve` at a small image size on the CPU: SAM ViT-B
    at its widths in bf16 behind a 2-layer C4 GCNN; `experiment.profile=true`
    prints the spans."""
    from equiadapt_tpu_torch.cli.segmentation_serve import main

    out = main(["dataset.image_size=32", "canonicalization.network_hyperparams.num_layers=2",
                "canonicalization.network_hyperparams.out_channels=2",
                "canonicalization.resize_shape=16", "experiment.batch_size=1",
                "experiment.profile=true", f"experiment.profile_dir={tmp_path}"], device="cpu")
    printed = capsys.readouterr().out
    sam = out["pipeline"].prediction_network
    assert isinstance(sam, SamModel) and sam.dtype == torch.bfloat16
    assert len(sam.image_encoder.blocks) == 12 and out["images_per_s"] > 0
    for span in ("pipeline", "canon/warp", "predict", "sam/attn/global", "sam/decoder"):
        assert f"\n  {span} " in printed, span
