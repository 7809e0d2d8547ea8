#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure raises and the exit code is non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the port's CUDA sources from this checkout;
3. kernels: K1 (steered rotate-select) and K2 (fused rotate-select-roll)
   against their plain PyTorch versions with `torch.equal` (fp32 and bf16;
   C4, C8, D8; C in {3, 16}; random indices, shifts and reflections; and the
   full main-path shapes);
4. main path at full width: batch 256, 224 px, C8 GCNN energy
   (3 -> 8 channels, 3x3, 2 layers), ResNet-50 (10 classes) and the
   invert of a (256, 224, 224, 16) regular-rep map, in the two presets of
   bench.py: exact / fp32 (crop 0.9, resize 64, unpooled GCNN) and serving
   / bf16 (fast warp, fused-pool GCNN, crop 1.0, resize 56, bf16 output).
   Launch counts are zeroed just before each preset and read just after;
   every kernel of the path must have launched. Outputs must be finite; the
   first samples must agree with the port's CPU run (plain kernels); and
   canonicalizing torch.rot90(x) must select the element shifted by two for
   at least 99% of the batch, with canonical images within 1e-4;
5. times (CUDA events, after warm-up): canonicalize + invert images/s, the
   canonicalizer's overhead over the bare ResNet-50, device time by kernel
   name for one canonicalize + invert and one ResNet-50 call
   (torch.profiler), and per kernel its time, its bound, its plain
   version's time and its launches.

Weights are random, from fixed seeds. fp32 work runs with TF32 off. The
last line is {"ok": true, "device": {...}}; the lines before it hold the
nvidia-smi line and the `kernels` JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import torch

B, IMAGE, NUM_ROT, FEATURE_CH = 256, 224, 8, 16
DEVICE = "cuda"
SOURCE = "equiadapt_tpu_torch/csrc/select_warp.cu"
TPU_KERNEL = {
    "select_planes": "equiadapt_tpu/ops/pallas/select_warp.py:233",
    "select_planes_rolled": "equiadapt_tpu/ops/pallas/select_warp.py:630",
}
# memory bandwidth of the card, bytes/s (NVIDIA data sheets)
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))


def log(*a):
    print(*a, flush=True)


def bandwidth_for(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no bandwidth figure for {name!r}")


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(sw, gen):
    """K1 and K2 against their plain versions; launches here are not counted
    as the main path's (the counts are zeroed before it)."""
    dev = DEVICE
    n_checked = 0
    cases = [(8, 72), (3, 40)]  # (batch, size): ragged 32x32 tiles
    for dtype in (torch.float32, torch.bfloat16):
        for group, (n, reflect) in {"C4": (4, False), "C8": (8, False),
                                    "D8": (8, True)}.items():
            G = 2 * n if reflect else n
            residues, src_of, k_of = sw._c_n_decomposition(n, 1.0)
            for b, size in cases:
                idx = torch.randint(0, n, (b,), generator=gen).to(dev)
                src = torch.tensor(src_of, device=dev)[idx].int()
                k = torch.tensor(k_of, device=dev)[idx].int()
                for C in (3, 16):
                    srcs = [torch.randn(b, C, size, size, generator=gen)
                            .to(dev, dtype) for _ in residues]
                    got = sw.select_planes(srcs, src, k)
                    ref = sw.select_planes_plain(srcs, src, k)
                    sync()
                    assert torch.equal(got, ref), ("K1", dtype, group, C, b, size)
                    n_checked += 1
                    if C % G:
                        continue
                    shift = torch.randint(-2 * n, 2 * n, (b,), generator=gen)
                    shift = shift.to(dev).int()
                    refl = (torch.randint(0, 2, (b,), generator=gen).to(dev).int()
                            if reflect else None)
                    got = sw.select_planes_rolled(srcs, src, k, shift, G, n, refl)
                    ref = sw.select_planes_plain(srcs, src, k, shift, refl, G, n)
                    sync()
                    assert torch.equal(got, ref), ("K2", dtype, group, C, b, size)
                    n_checked += 1
    log(f"kernel checks: {n_checked} small cases torch.equal to the plain versions")


def main_shape_inputs(sw, gen, C, dtype, rolled):
    """Sources and indices at a main-path shape: the batch and its 45-degree
    residual warp (C8, two sources)."""
    residues, src_of, k_of = sw._c_n_decomposition(NUM_ROT, 1.0 if rolled else -1.0)
    idx = torch.randint(0, NUM_ROT, (B,), generator=gen).to(DEVICE)
    src = torch.tensor(src_of, device=DEVICE)[idx].int()
    k = torch.tensor(k_of, device=DEVICE)[idx].int()
    srcs = [torch.randn(B, C, IMAGE, IMAGE, device=DEVICE).to(dtype)
            for _ in residues]
    shift = idx.int() if rolled else None
    return srcs, src, k, shift


def kernel_entry(sw, name, dtype, gen, bw, launches):
    """Check and time one kernel at its main-path shape."""
    rolled = name == "select_planes_rolled"
    C = FEATURE_CH if rolled else 3
    srcs, src, k, shift = main_shape_inputs(sw, gen, C, dtype, rolled)
    if rolled:
        run = lambda: sw.select_planes_rolled(srcs, src, k, shift, NUM_ROT, NUM_ROT)
        plain = lambda: sw.select_planes_plain(srcs, src, k, shift, None,
                                               NUM_ROT, NUM_ROT)
    else:
        run = lambda: sw.select_planes(srcs, src, k)
        plain = lambda: sw.select_planes_plain(srcs, src, k)
    got, ref = run(), plain()
    sync()
    assert torch.equal(got, ref), (name, dtype, "main-path shape")
    err = (got.float() - ref.float()).abs().max().item()
    ms = cuda_ms(run, reps=20)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    nbytes = 2 * got.numel() * got.element_size() + sum(
        t.numel() * t.element_size() for t in (src, k, shift) if t is not None)
    bound_ms = nbytes / bw * 1e3
    tag = str(dtype).removeprefix("torch.")
    del srcs, got, ref
    return {
        "name": f"{name}[{tag}]", "route": "cuda", "source": SOURCE,
        "replaces": TPU_KERNEL[name], "launches": launches.get(f"{name}/{tag}", 0),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "shape": [B, C, IMAGE, IMAGE], "bytes": nbytes,
    }


def build_presets(tp):
    torch.manual_seed(0)
    net = tp.EquivariantNetwork(3, 8, 3, group_type="rotation",
                                num_rotations=NUM_ROT, num_layers=2,
                                device=DEVICE)
    net_pooled = tp.EquivariantNetwork(3, 8, 3, group_type="rotation",
                                       num_rotations=NUM_ROT, num_layers=2,
                                       fused_pool_lift=True, device=DEVICE)
    net_pooled.load_state_dict(net.state_dict())
    common = dict(in_shape=(IMAGE, IMAGE, 3), num_rotations=NUM_ROT,
                  group_type="rotation")
    exact = tp.GroupEquivariantImageCanonicalization(
        net, input_crop_ratio=0.9, resize_shape=64, warp_mode="exact", **common)
    serving = tp.GroupEquivariantImageCanonicalization(
        net_pooled, input_crop_ratio=1.0, resize_shape=56, warp_mode="fast",
        compute_dtype=torch.bfloat16, output_dtype="compute", **common)
    torch.manual_seed(1)
    resnet = tp.ResNet50(num_classes=10, device=DEVICE)
    resnet_bf16 = tp.ResNet50(num_classes=10, dtype=torch.bfloat16,
                              device=DEVICE)
    resnet_bf16.load_state_dict(resnet.state_dict())
    with torch.no_grad():  # BN statistics away from the init's 0 / 1
        for m in list(resnet.modules()) + list(net.modules()):
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        net_pooled.load_state_dict(net.state_dict())
        resnet_bf16.load_state_dict(resnet.state_dict())
    for m in (exact, serving, resnet, resnet_bf16):
        m.eval()
    return {"exact": (exact, resnet), "serving": (serving, resnet_bf16)}


def smooth_images(gen):
    """Low-frequency images plus noise: oriented content, so the random
    energy network separates its top two elements clearly (white noise
    leaves margins near 1e-5)."""
    lo = torch.randn(B, 3, 6, 6, generator=gen)
    up = torch.nn.functional.interpolate(lo, size=(IMAGE, IMAGE), mode="bicubic",
                                         align_corners=False)
    return 4.0 * up.permute(0, 2, 3, 1) + 0.5 * torch.randn(
        B, IMAGE, IMAGE, 3, generator=gen)


def run_path(canon, resnet, x, y):
    x_c, info = canon.canonicalize(x)
    logits = resnet(x_c)
    y_inv = canon.invert_canonicalization(info, y)
    return x_c, info, logits, y_inv


def check_against_cpu(canon, resnet, x, y, x_c, info, logits, y_inv, m=8):
    """The first m samples against the port's CPU run (plain kernels)."""
    canon_cpu = copy.deepcopy(canon).to("cpu")
    resnet_cpu = copy.deepcopy(resnet).to("cpu")
    xc_r, info_r, logits_r, yi_r = run_path(canon_cpu, resnet_cpu,
                                            x[:m].cpu(), y[:m].cpu())
    acts = info_r.group_activations
    top2 = acts.sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    sel = info.onehot[:m].argmax(-1).cpu()
    same = sel == info_r.onehot.argmax(-1)
    assert clear.sum() >= m // 2 and bool(same[clear].all()), (sel, acts)
    d_act = (info.group_activations[:m].cpu() - acts).abs().max().item()
    d_img = (x_c[:m].cpu()[same] - xc_r[same]).abs().max().item()
    d_inv = (y_inv[:m].cpu()[same] - yi_r[same]).abs().max().item()
    d_log = ((logits[:m].cpu() - logits_r).abs().max()
             / logits_r.abs().max()).item()
    assert d_act < 1e-4 and d_img < 1e-4 and d_inv < 1e-4 and d_log < 1e-3, (
        d_act, d_img, d_inv, d_log)
    return {"samples": m, "same_element": int(same.sum()), "max_abs_act": d_act,
            "max_abs_image": d_img, "max_abs_invert": d_inv,
            "max_rel_logit": d_log}


def check_equivariance(canon, x, x_c, info):
    """canonicalize(rot90(x)) selects element + 2 (mod 8) and gives the same
    canonical image."""
    x_rot = torch.rot90(x, 1, dims=(1, 2)).contiguous()
    x_c_rot, info_rot = canon.canonicalize(x_rot)
    sel = info.onehot.argmax(-1)
    sel_rot = info_rot.onehot.argmax(-1)
    ok = sel_rot == (sel + 2) % NUM_ROT
    share = ok.float().mean().item()
    err = (x_c_rot[ok] - x_c[ok]).abs().max().item()
    assert share >= 0.99 and err < 1e-4, (share, err)
    return {"share_shifted": share, "max_abs_image": err}


def device_profile(fn, top: int = 25):
    """Device time by kernel name over one call of fn (after a warm-up
    call): [name, ms, calls] rows, largest first, then the total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        sync()
    rows = []
    for e in p.key_averages():  # kernel rows only: operator rows repeat them
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append([e.key[:90], us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    return rows[:top] + [["all kernels", sum(r[1] for r in rows),
                          sum(r[2] for r in rows)]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the full results as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import equiadapt_tpu_torch as tp
    from equiadapt_tpu_torch.ops.kernels import _build
    from equiadapt_tpu_torch.ops.kernels import select_warp as sw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw = bandwidth_for(name)
    log(f"device: {name}; nvidia-smi: {smi}; bandwidth used for bounds "
        f"{bw / 1e12:.2f} TB/s; torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = {"device": name, "nvidia_smi": smi, "bandwidth": bw}

    t0 = time.perf_counter()
    _build.build_all()
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.1f} s")
    for src, text in _build.build_logs.items():
        log(f"nvcc {src}.cu:\n{text.strip()}")

    gen = torch.Generator().manual_seed(0)
    check_kernels(sw, gen)

    presets = build_presets(tp)
    x = smooth_images(gen).to(DEVICE)
    y = torch.randn(B, IMAGE, IMAGE, FEATURE_CH, generator=gen).to(DEVICE)
    ys = {"exact": y, "serving": y.to(torch.bfloat16)}
    launches, checks, times = {}, {}, {}
    with torch.no_grad():
        for preset, (canon, resnet) in presets.items():
            sw.reset_launches()
            out = run_path(canon, resnet, x, ys[preset])
            sync()
            counts = dict(sw.launches)
            launches.update(counts)
            log(f"{preset}: launches {counts}")
            tag = "float32" if preset == "exact" else "bfloat16"
            for kname in TPU_KERNEL:
                assert counts.get(f"{kname}/{tag}", 0) > 0, (preset, kname, counts)
            x_c, info, logits, y_inv = out
            assert x_c.shape == x.shape and logits.shape == (B, 10)
            assert y_inv.shape == ys[preset].shape
            for t in (x_c, logits, y_inv, info.group_activations):
                assert bool(torch.isfinite(t.float()).all()), preset
            if preset == "exact":
                checks["cpu"] = check_against_cpu(canon, resnet, x, y, *out)
                checks["rot90"] = check_equivariance(canon, x, x_c, info)
                log(f"exact: vs CPU {checks['cpu']}; rot90 {checks['rot90']}")
            del out, x_c, info, logits, y_inv

            yy = ys[preset]
            t_bare = cuda_ms(lambda: resnet(x), reps=5)
            t_wrapped = cuda_ms(lambda: resnet(canon.canonicalize(x)[0]), reps=5)
            t_canon = cuda_ms(lambda: canon.canonicalize(x), reps=5)

            def canon_invert():
                _, inf = canon.canonicalize(x)
                canon.invert_canonicalization(inf, yy)

            t_ci = cuda_ms(canon_invert, reps=5)
            times[preset] = {
                "resnet50_ms": t_bare, "canon_resnet50_ms": t_wrapped,
                "canonicalize_ms": t_canon, "canon_invert_ms": t_ci,
                "canon_invert_img_per_s": B / t_ci * 1e3,
                "overhead_pct": (t_wrapped - t_bare) / t_bare * 100.0,
            }
            log(f"{preset}: {json.dumps(times[preset])}")
            prof = {"canon_invert": device_profile(canon_invert),
                    "resnet50": device_profile(lambda: resnet(x))}
            times[preset]["profile"] = prof
            for part, rows in prof.items():
                log(f"{preset} profile {part}: {json.dumps(rows[:12] + rows[-1:])}")

        kernels = []
        for dtype in (torch.float32, torch.bfloat16):
            for kname in TPU_KERNEL:
                kernels.append(kernel_entry(sw, kname, dtype, gen, bw, launches))
    results.update(launches=launches, checks=checks, times=times,
                   kernels=kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
