"""Time a PyTorch port's wavefront frame on the card: the sphere field's,
the command line's

    benchmark builtin:sphere_field --size 512x512 --spp 1 --intersector pallas
        --bvh-kernel KERNEL

config (its parser and _build give the settings), with KERNEL "ftb" (K3),
"cluster" (K7c-e), "dfs" (K7f / K7g) or "binned" (K7a / K7b); or, with
"cornell", the Cornell frame that chip_smoke.py's main phase drives
through render_image_stats_auto: 512x512, 1 spp, d50, the power light
pick, which the megakernel does not cover, so the wavefront runs on K2.
The port imported is the one on PYTHONPATH:

    PYTHONPATH=ROOT python3 tools/torch_wavefront_ab.py KERNEL|cornell [profile]

After a warmup frame it prints one line per timed frame (timestamps 100
and 101).  With "profile" it renders timestamp 100 again under
torch.profiler and prints the device's busy milliseconds (the device
events' own time: kernels and copies on one stream, which do not overlap),
the idle share against the unprofiled frame at that timestamp (the
profiler slows the host), and the 25 device events with the most device
time, then the port's hand-written kernels among the rest, with their
launches.  To compare two trees on one card, unpack the
other tree (git archive) into a directory that .gitignore lists and run
the two in one call in the order parent, change, change, parent.
"""
import os
import sys
import time

import torch

from gpuspectral_tpu_torch.cli import main as cli
from gpuspectral_tpu_torch.integrator import render_image_stats_auto
from gpuspectral_tpu_torch.integrator.path_tracer import render_image_stats

kernel = sys.argv[1]
if kernel == "cornell":
    from gpuspectral_tpu_torch.scene import load_mitsuba_scene
    from gpuspectral_tpu_torch.utils import RenderConfig

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_mitsuba_scene(os.path.join(here, "scenes", "cornell", "scene.xml"),
                               device="cuda")[0]
    cfg = RenderConfig(width=512, height=512, spp=1, max_depth=50, ray_batch=65536,
                       light_sampling="power")
    render = render_image_stats_auto  # the dispatch takes the wavefront: K1 has no power pick
else:
    scene, cfg = cli._build(cli.parser().parse_args([
        "benchmark", "builtin:sphere_field", "--size", "512x512", "--spp", "1",
        "--intersector", "pallas", "--bvh-kernel", kernel]))
    render = render_image_stats
where = cli.__file__.rsplit("/gpuspectral_tpu_torch/", 1)[0]
render(scene, cfg, 0)
torch.cuda.synchronize()
seconds = {}
for ts in (100, 101):
    t0 = time.perf_counter()
    img, rays = render(scene, cfg, ts)
    torch.cuda.synchronize()
    seconds[ts] = dt = time.perf_counter() - t0
    print(f"AB root={where} kernel={kernel} ts={ts} s={dt:.4f} rays={rays:.0f} "
          f"mrays_per_s={rays / dt / 1e6:.4f} mean={float(img.mean()):.6f}", flush=True)
if "profile" in sys.argv[2:]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, cfg, 100)
        torch.cuda.synchronize()
    # the device's own events: a host op's device time is that of the
    # kernels it launched, which are events of their own
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    print(f"PROFILE kernel={kernel} ts=100 device_busy_ms={busy:.1f} "
          f"idle_share={1.0 - busy / (seconds[100] * 1e3):.3f}", flush=True)
    # the top 25, and every hand-written kernel of the port (csrc/*.cu, in
    # an anonymous namespace) below them
    for k, ms, c in dev[:25] + [x for x in dev[25:] if x[0].startswith("(anonymous namespace)")]:
        print(f"PROFILE {k[:90]} device_ms={ms:.3f} launches={c}", flush=True)
