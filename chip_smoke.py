#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from the sources in the checkout
   (four libraries, one ``nvcc`` per source, all started together);
3. hold K1 stitch and K2 unstitch bit-exact against their plain PyTorch
   versions on packer-built plans at canvas 1024 (f32, bf16, int8, uint8,
   placements flush with the canvas edges, an empty plan); then K1 alone
   in each payload dtype at C 1, 3 and 4 on its edge cases (45-pixel
   canvas rows, no multiple of 16 bytes; placements across its row tiles;
   overlapping placements, where the last record in k order wins; 2,048
   records on one canvas), and its C entry called directly on outputs
   filled with 0xFF bytes;
3b. hold K4 stitch->embed (f32 weights within 1e-4 with TF32 off in the
   plain matmul, bf16 within 2e-2) and K3 decode->gather (within 1e-5,
   equal hit masks but for centres within 1e-4 px of a placement edge)
   against their plain versions on the same plans and an all-invalid one,
   at patch 32 and d 768; then K3 on slots named by two records (the last
   wins), slots no record names, placement edges off the cell grid and
   centre logits of +-30 (32^2 cells, 16-byte stores, and 33^2, scalar
   stores), and its C entry called directly on outputs filled with 0xFF
   bytes;
3c. hold K5, the GMM background update, bit-equal (w, mu, var and the
   foreground mask) against its plain version at 3840x2160: 16
   consecutive frames of the 4K synthetic scene with the state carried,
   random states and frames, a tie-laden state, and ragged sizes (1x1,
   7x13, 2160x3840);
4. make the 2048x1024 serve trace on the card through K5 and again
   through the plain GMM, and require equal arrivals and frames; serve the
   trace through the full-width ``tangram`` detector (ViT-B/32 trunk,
   1024^2 canvases, bf16) with the sync executor, once through the
   kernels and once through the plain versions, and require equal routed
   detections, bit-equal evidence pixels and head outputs, and 0 frames
   held;
5. serve the same trace through the async executor and require the same;
5b. serve it again on the fused path (K4 -> trunk from tokens -> K3):
   kernels sync, plain sync, kernels async; require K3/K4 launched and
   K1/K2 not (nothing in the plain run), 0 frames held, the unfused runs'
   invocation boundaries and bit-equal evidence, kernel and plain raw heads
   and routed detections within the stated bf16 tolerances, async equal to
   sync; print how far fused and unfused detections agree;
5c. build the registry's ``tangram_int8`` at full width (``tangram``
   from the same seed, its trunk kernels int8 with float32 scales, the
   patch embed and head in bf16), require its head objectness on the
   trace's canvases to correlate with the bf16 build's above 0.98, print
   both builds' resident weight bytes, trunk times (CUDA events, 1 and 4
   canvases) and modeled ``mu``, and serve the trace with it as phases 4,
   5 and 5b serve the bf16 detector, under the same checks;
5d. serve the trace at SLO 1.0 s through ``TangramScheduler`` over a fused
   ``DeviceExecutor`` of the full-width detector and print its
   ``Results.summary()`` (cost and platform invocations read 0: the
   platform carries only the meter); again with ``online_latency=True``
   (a one-worker pool feeds the online table every completion), and
   print both violation rates (a reading, not a gate);
5e. profile the full-width detector on the card over 1, 2, 4 and 8
   canvases, and run Tangram, Clipper, ELF and MArk in simulation over
   that table (``benchmarks/fig12_e2e.py``'s grid: 20/40/80 Mbps x SLO
   0.5/1.0/1.5 s) on four synthetic 2048x1024 cameras' patches made on
   the card; print each arm's cost and violation rate;
4c. this slice's path at full width: write a 16-frame 8-bit recording of
   the 4K scene, serve it through ``make_source("file")`` on the fused
   path with the full-width detector, once with the kernels and once with
   the plain versions; require equal arrivals, detections within the
   fused tolerances, 0 frames held, K5 once per frame in the kernel run and
   never in the plain run; print each 4K frame's seconds per edge stage;
   run the serve driver on the recording once (``--source file --fuse``);
5f. serve the registry's three detectors at full width (``vit_s16``:
   ViT-S/16 trunk at patch 16, a 64x64 token grid a canvas;
   ``efficientnet_b7``: 18 layers at d 512, patch 32; ``tangram``) on
   three 2048x1024 cameras, one an SLO class (0.5 / 1.0 / 2.0 s, made as
   the serve driver's comma list of SLOs makes them), routed by
   ``MODEL_MAP``: unfused and fused with the sync executor on each
   model's profiled table, kernels and plain (unfused evidence, heads and
   detections equal; fused within phase 5b's limits); then through
   ``TangramScheduler`` over a two-worker ``device_worker_pool`` with
   model placement, weight caches and online tables, unfused and fused,
   each invocation replayed through the plain versions and held the same
   way; every model's invocations must launch K1/K2 (K4/K3) and the plain
   runs nothing, with 0 frames held; print the per-model and per-worker
   rows (weight hits, drift) and the invocations;
5g. fleet sharding: three 2048x1024 cameras (24 frames each through K5)
   served by the full-width ``tangram`` detector through the serve
   driver's ``--shards 2`` objects (cameras 0 and 2 on shard 0, camera 1
   on shard 1), each shard's sync executor on its own CUDA stream,
   unfused and fused, sequential (``ShardedEngine``) and ``--parallel``
   (``ParallelShardedEngine``, a thread a shard): require every patch
   served, 0 frames held, each shard's trunk on its own stream, K1/K2
   (K4/K3) launched once an invocation summed over the shards, the same
   per-shard boundaries, evidence and detections (heads bit-equal, or the
   difference printed and held to phase 5b's limits) sequential and
   parallel, every invocation replayed through a plain executor and held
   as phase 5f holds its pool, and the shards' patches those of the
   unsharded run; print the shard rows, stream ids and wall times; then
   ``TangramScheduler(shards=4, planner="cost")`` over 1,000 simulated
   cameras (``FleetCameraSource``, 60 s) on phase 5e's table, sequential
   and parallel, with equal ``Results.summary()`` required and the host's
   arrivals per second printed;
6. time each kernel against its plain version and its bound (K1-K4 at the
   main path's largest invocation, K4 and K3 again at ``vit_s16``'s and K4
   at ``efficientnet_b7``'s largest fused invocation of phase 5f, K5 on
   4K and 2048x1024 frames), and
   time the unfused and the fused invocation's stages.  Every kernel (and
   library yardstick) gets two times: ``ms_call``, calls back to back
   between CUDA events, which holds the wrapper's host time wherever it
   outlasts the device's, and ``ms_device``, the same calls captured in one
   CUDA graph and replayed, the card's time alone (``torch.profiler``'s
   sum of the device activities beside it as a cross-check); K3's row also
   gives ``launch_floor_ms``, one trivial PyTorch launch in the same
   graph harness;
7. hold K6 flash attention and K7 flash decode against their plain
   versions (bf16 within 2e-2, float32 within 1e-4, and every output row
   within ATTN_ROW_TOL of its own scale): K6 causal at
   minitron-4b's per-layer shape (B=2, S=4096, 24 query heads over 8 KV
   heads, D=128), with segment ids of requests packed into 4096-token rows
   by ``core.sequence_packing``, non-causal at the ViT-B/16 encoder's 197
   tokens, causal at a ragged 4095, in float32, and at deepseek-moe-16b's
   16 heads over 16 (G = 1); K7 on a 4096-position cache at pos 0, 63,
   64, 511, 512 and 4095 (one chunk a pair to eight), at G 1, 8 and 24
   with D 32, 64 and 128, at G = 1 and D 128 (deepseek-moe-16b's cache,
   pos 79 and 4095), at B=64 (one chunk), in float32,
   on a one-card decode_32k slice (B=8, 32768 positions), at pos 5 of
   32768 (seven empty blocks a cluster), and called back to back at
   positions whose live chunks differ; every K7 case also at ``pos`` a 0-d
   int32 on the card, bit-equal to the host-int launch; then plant four
   faults through the kernels themselves (K6 and K7 skipping one KV tile,
   K7 one chunk of its split, K7's merge one chunk's partial) and require
   the check to reject each;
8. the LM path at full width: ``minitron-4b`` (5.10 B parameters, bf16,
   random weights drawn on the card from a seed) prefills B=2 x 4096
   tokens and decodes 256 teacher-forced then 32 greedy steps from an
   empty 4096-position cache, once through the kernels (K6 on every layer
   of prefill, K7 on every layer of every decode step) and once through
   the plain versions; require the kernel and plain logits (last prefill
   position, prefill positions 0-255, decode positions 0-255), and each
   run's decode logits at positions 0-255 against its prefill logits
   there, within LOGIT_TOL, equal greedy ids wherever the
   plain top-2 margin is at least LOGIT_TOL, and K6 32 / K7 288 x 32
   launches in the kernel runs and none in the plain ones; time K6 and K7
   against the plain versions, SDPA and their bounds (K7 at a device pos
   too), and print the prefill's split, a decode step against its byte
   bound and the peak device memory;
8a. one decode step captured in a CUDA graph: on static tokens, ``pos`` a
   0-d int32 on the card and phase 8's kernel cache written in place
   (``cache_update="auto"``), replayed at 32 consecutive positions after
   the 288 decoded, the greedy token and ``pos + 1`` written on the card
   between replays; each replay's logits, and the cache, bit-equal to
   the eager step at the host int on a copy of the cache (or within
   LOGIT_TOL), K7 32 launches at capture and none counted by a replay;
   print the replay's and the eager step's times and the byte bound;
   phase 8d does the same for deepseek-moe-16b (positions 80-111), held
   by its routing agreement and logit statistics;
8b. quantize phase 8's weights on the card (int8 layer and ``lm_head``
   kernels) and run minitron-4b with an int8 KV cache: prefill B=2 x 2048
   through K6 (kernels vs plain within LOGIT_TOL, logits correlating with
   the bf16 model's above 0.99) and 32 teacher-forced decode steps
   through K7 over the dequantized cache (its logits correlating with a
   bf16 cache's above 0.995); print the resident bytes, the prefill and
   step times and the peak device memory;
8c. the vision and diffusion zoo at full width, seeded random bf16
   weights drawn on the card: ViT-B/16 and DeiT-B at serve_b128 (B=128,
   224^2), DeiT-B at cls_384 (B=64, its position grid resized 14 -> 24,
   578 tokens), ViT-S/16 at B=1 and B=128, each through K6
   (``impl="flash"``) and through its plain version (``impl="torch"``):
   logits within ZOO_ROW_TOL of each row's RMS, top-1 equal wherever the
   plain top-2 margin exceeds that limit, K6 once a layer in the kernel
   run and nothing in the plain one; DiT-S/2 and DiT-XL/2 at gen_fast
   (B=16, 512^2, 1,024 latent tokens, 4 DDIM steps) the same way: the
   first step's eps within DIT_EPS_TOL of its RMS, final latents
   correlating above DIT_LATENT_CORR; DiT-XL/2 at gen_1024 (B=4, 4,096
   tokens, heads of 72 on K6's wgmma kernel, laid out at 80): one forward
   both ways, then 50 DDIM steps through K6 alone, timed a step;
   EfficientNet-B7 at 600^2, B=8: serve time and peak memory, K1-K7
   launched 0 times; then K6 timed at ViT-B/16's and DiT-XL/2's layer
   shapes against its plain version, SDPA and its bound;
8d. the MoE LM at full width: ``deepseek-moe-16b`` (16.88 B parameters,
   bf16, random weights drawn on the card from a seed; 64 routed experts
   top-6 and 2 shared, GShard dispatch in groups of 512 at capacity
   factor 1.25) prefills B=2 x 4096 tokens and decodes 64 teacher-forced
   then 16 greedy steps from an empty 4096-position cache, through the
   kernels (K6 28 launches a prefill, K7 28 a step) and plain (none); the
   share of routing decisions equal in the two prefills, per layer, and
   the correlation and median and 99th percentile of |dlogit| (prefill
   last position and positions 0-63, decode 0-63) within their limits;
   decode against prefill (B=2 x 512) with a capacity factor that drops
   nothing; int8 weights quantized on the card (prefill B=2 x 2048
   through K6, logits correlating with bf16's above 0.99); K6 and K7
   timed at its shapes (G = 1, D 128); the prefill's split (K6, router
   and top-k rounds, the dispatch, expert and combine einsums, the shared
   expert, the attention projections), a decode step against its byte
   bound (every expert read every step), device idle shares and peak
   memory;
10. training, which launches none of K1-K7 (the reference trains without
   a Pallas kernel): (a) one train step (``make_train_step``'s parts:
   loss and gradients, AdamW) of the reduced detector (canvas 256,
   float32, B=4 from the port's loader) on the card and on the CPU with
   TF32 off, the loss within 1e-5 relative, every gradient leaf within
   1e-4 of its max-abs and the parameters after AdamW on the CPU's
   gradients within 1e-5 (after each side's own gradients they are
   printed: AdamW's first step amplifies the rounding of gradient
   elements near its eps); the same for the reduced LM (``minitron-4b``'s family) at B=2 x 4096 with
   ``"xla"`` and with ``"chunked"`` attention (two chunks of 2048), the two
   within 1e-4 of each other; the LM's remat policies (``dots``,
   ``minimal``) against remat off on the card, the loss bit-equal; (b) the
   full-width ``tangram-detector`` at ``train_c32`` (canvas 1024, B=32,
   bf16, remat off, weights drawn on the card from a seed, batches from
   ``data/loader.detector_batches``): the loader's and the host->device
   copy's times a batch, the device step time (CUDA events, median after
   the first step), canvases a second, the step's forward / backward /
   optimizer split, peak memory and the device's idle share in a profiled
   step; 12 ``launch/train.train`` steps with a checkpoint every 4 and a
   failure drill at step 9 against a run without it (the same losses to
   step 8, then the restored step-8 state's); 20 steps on one batch (the
   loss falls); one step with remat on (the loss bit-equal to remat off,
   deterministic algorithms on; its peak memory); no K1-K7 launch in the
   whole phase, and K6 refusing inputs that require grad;
11. the mesh (no kernel of its own; K1-K5 on its serve path): (a) the
   2048x1024 trace through the full-width ``tangram`` detector at SLO
   5.0 s on the card's serve mesh (``make_serve_mesh()``: data=1) and on
   a data=2 mesh laid over the card twice, unfused, then fused on the
   data=2 mesh; require equal boundaries and bit-equal evidence, the
   data=2 heads and detections within phase 5b's bf16 limits of the
   data=1 run's (the half batches may tile their GEMMs otherwise),
   ``n_sharded`` 0 at data=1, every invocation at data=2 and 0 fused,
   K1/K2 (K4/K3) launched; print the summary lines; (b) plan and count
   ``tangram-detector``'s ``serve_c1`` and ``serve_c8`` on the unit mesh
   (``api.plan_cell``, ``dryrun.run_cell``) and run the same steps on the
   card from seeded weights: ``FlopCounterMode``'s FLOPs and the
   argument bytes must equal the dry run's; print ``t_compute`` beside
   the CUDA-graph device time, ``hbm_estimate`` beside the step's own
   peak memory (the peak less what was live before the step, plus the
   arguments) and the data sheet's memory beside the card's; (c)
   meanwhile, in one worker process a host CPU, ``dryrun --all --mesh
   production --quick`` with every model cut to ``DRYRUN_DEPTH`` layers
   (``dryrun.cut_depth``: widths, microbatches and sampler steps as the
   cells have them; the full depth is the CLI's): all 40 cells must
   plan and count (rows in ``build/dryrun_production.json``);
12. the hillclimb (``launch/hillclimb.py``) and the masked KV-cache
   write: (a) the K4 tile search (``run_kernel_blocks``) at the K4 rows'
   geometries (1024^2 canvases; ``tangram`` patch 32 d 768, ``vit_s16``
   patch 16 d 384, ``efficientnet_b7`` patch 32 d 512): every tile of
   ``K4_TILES`` bit-equal to the default tile and within 2e-2 of the
   plain version, each tile's host-clock and CUDA-graph times, and
   ``pick_tile``'s answer; (b) phase 8's full-width ``minitron-4b`` (its
   weights kept in host memory since phase 8b, no second draw) fills a
   cache with 32 teacher-forced steps, then 16 steps through K7 with
   ``cache_update="masked"`` from a copy of it against the same 16 with
   ``"dus"``: logits and caches bit-equal, the masked run's input cache
   untouched, K7 once a layer a step, one step's time each beside its
   byte bound; (c) meanwhile, in worker processes, the hillclimb's 23
   variants and ``detector_stitch`` on the 16 x 16 production mesh, every
   model cut to ``DRYRUN_DEPTH`` layers, direct counts (rows in
   ``build/hillclimb.json``; their ``t_*`` are the plan priced on the
   H100 data sheet, not measurements);
13. the port's four examples (``examples/torch_*.py``), each run in
   process at its own arguments on the card, with one line each (wall,
   launches by kernel, the card): ``torch_quickstart`` (K5's 40-frame
   edge stream equal, patch for patch, to the plain GMM's on the card and
   the CPU's, and its report equal to theirs), ``torch_serve_e2e`` (K5,
   K1 and K2; patches, invocations and frames held equal to the example
   with ``--device cpu``, routed detections too, but for scores within
   1e-3 of 0.5), ``torch_lm_sequence_packing`` (float32 K6 in the
   forward and with ``segment_ids``, within 1e-4 of the plain calls, and
   again on random q, k, v with the row's segment ids) and
   ``torch_train_detector`` (its own assertion that training learns, the
   drill restored once, no kernel);
9. print one JSON line of kernels (K1-K7, the K4/K3 rows of phase 5f's
   models, named ``kernel[model]``, phase 8c's ``K6[vit-b16]`` and
   ``K6[dit-xl2]`` and phase 8d's ``K6[deepseek-moe-16b]`` and
   ``K7[deepseek-moe-16b]``; ``launches_by_path`` has phase 10's
   ``train`` counts, all 0, phase 11's serve runs, phase 12's tile
   search and decode runs and phase 13's ``example_*`` runs) and, last,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, param  # noqa: E402
from repro_torch.config import HardwareConfig, dtype_of  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import gmm as gmm_core  # noqa: E402
from repro_torch.core import partitioning  # noqa: E402
from repro_torch.core import sequence_packing  # noqa: E402
from repro_torch.core.config import ServeConfig  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    InvokerPool, ModelRuntime, ServingEngine, data_devices, make_executor,
    slo_class, uniform_pool)
from repro_torch.core.invoker import SLOAwareInvoker  # noqa: E402
from repro_torch.core.models import make_model, register_model  # noqa: E402
from repro_torch.core.partitioning import Patch  # noqa: E402
from repro_torch.core.rois import RoIConfig, extract_rois  # noqa: E402
from repro_torch.core.scheduler import TangramScheduler  # noqa: E402
from repro_torch.core.stitching import build_batch_plan, stitch  # noqa: E402
from repro_torch.core.fleet import fleet_uniform_pool  # noqa: E402
from repro_torch.core.workers import (  # noqa: E402
    WorkerPoolExecutor, device_worker_pool, make_placement,
    share_frame_store, weight_caches)
from repro_torch.configs import tangram_detector  # noqa: E402
from repro_torch.data import loader  # noqa: E402
from repro_torch.data.synthetic import Scene, preset  # noqa: E402
from repro_torch.data.video import load_frames  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash as flash_kernels  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.gmm import gmm as gmm_kernels  # noqa: E402
from repro_torch.kernels.gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.launches import (  # noqa: E402
    LAUNCHES, reset_launches)
from repro_torch.kernels.stitch import fused_embed  # noqa: E402
from repro_torch.kernels.stitch import ops as stitch_ops  # noqa: E402
from repro_torch.kernels.stitch import stitch as stitch_kernels  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_serve_mesh, make_worker_meshes)
from repro_torch.launch.serve import (  # noqa: E402
    build_source, detail_lines, fused_fields, fused_kwargs, profile,
    shard_lines, shard_stream, sharded_engine, summary_line)
from repro_torch.models import detector as detector_lib  # noqa: E402
from repro_torch.models import dit  # noqa: E402
from repro_torch.models import efficientnet as effnet  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models import vit  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.serverless.platform import (  # noqa: E402
    Platform, PlatformConfig)
from repro_torch.sources import FleetCameraSource, make_source  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.elastic import (  # noqa: E402
    FailureEvent, FailureInjector)
from repro_torch.training.train_state import (  # noqa: E402
    make_train_step, value_and_grad)

CANVAS = 1024
PATCH = 32
D_MODEL = 768
H100 = HardwareConfig()
F32_PEAK = 67e12    # float32 FLOP/s on the CUDA cores (H100 SXM data sheet)
UNFUSED = ("stitch", "unstitch")
FUSED = ("stitch_embed", "unstitch_decode")
GMM = ("gmm_update",)

CAM_W, CAM_H = 3840, 2160        # the paper's 4K cameras
EDGE_FRAMES = 16                 # warm-up eats the first 10 at 10 fps
GMM_KEYS = ("w", "mu", "var")
#: K5 per pixel: 36 B of state read, 4 B of frame, 36 B of state written,
#: 1 B of mask; about 100 float32 operations
GMM_BYTES_PER_PIXEL = 77
GMM_OPS_PER_PIXEL = 100

# Fused kernel run vs fused plain run.  K4 sums in another order than the
# plain matmul, so a token may round one bf16 ulp apart, and the 12-layer
# bf16 trunk carries that to the head.  Measured on an H100 80GB HBM3 at
# 700 W over both traces (PERF.md): raw head 0.039, decoded score 0.0071,
# box 2.69 px at most; the limits are about three times those.  A box edge
# moves by up to 32 * (0.25 * d_centre + 0.5 * exp(r) * d_size) px for a
# raw change d, so its limit is in pixels, not a share of the raw one.
RAW_TOL = 0.125
SCORE_TOL = 0.025
BOX_TOL = 8.0
# A decoded centre moves by at most patch * sigmoid' * d = 32 * 0.25 * d
# px for a raw change d, so between two runs within RAW_TOL a cell can
# change placement (and be routed by one run only) only if its centre lies
# within this many px of a placement edge.
EDGE_TOL = PATCH * 0.25 * RAW_TOL


# Phases 7 and 8: minitron-4b (32 layers, d 3072, 24 query heads over 8
# KV heads, head_dim 128, d_ff 9216, vocab 256000, bf16) at full width.
LM_ARCH = "minitron-4b"
LM_SEED = 14
LM_BATCH, LM_SEQ = 2, 4096       # prefill; the decode cache's Smax
LM_FORCED, LM_GREEDY = 256, 32   # teacher-forced, then greedy decode steps
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The absolute limits above are as large as a typical output late in a long
# row (its RMS is ~sqrt(e / n) over n keys: 0.026 at n = 4096, 0.009 at
# 32768), so a kernel that skipped a KV tile there would pass them.  Each
# output row (one query position and head, over D) is therefore also held
# to its own scale: max_d |got - want| <= ATTN_ROW_TOL * rms_d(want).
# A correct kernel differs by an ulp or two of a row's largest element.
# Measured on an H100 80GB HBM3 at 700 W over phase 7's cases (PERF.md):
# K6 0.0633 (packed rows) in bf16 and 3.33e-6 in float32, K7 0.0256 (the
# 32k slice); each limit is three times its reading.  Over phase 7's wider
# set of K7 cases the cluster kernel reads up to 0.036 (B=64), 3.5e-6 in
# float32.  Phase 7's planted faults read 1.06-2.57 against them.
# K7 in float32 (phase 7's one case, off the main path) takes K6's float32
# limit.
ATTN_ROW_TOL = {("k6", torch.bfloat16): 0.19, ("k6", torch.float32): 1e-5,
                ("k7", torch.bfloat16): 0.077, ("k7", torch.float32): 1e-5}
# Kernel run vs plain run, and K7 decode vs K6 prefill, in logits of the
# random full-width model (|logit| up to ~5, a bf16 ulp 0.03 there).
# Measured on an H100 80GB HBM3 at 700 W (PERF.md): last-position prefill
# logits kernel vs plain 0.102, teacher-forced decode vs prefill 0.117
# with kernels and 0.109 plain; the limit is three times the largest.
LOGIT_TOL = 0.35

# Phases 5c and 8b: int8-resident weights.  The fp-vs-int8 correlation
# bounds are the JAX package's own tests' (tests/test_int8_serving.py: the
# detector's objectness; tests/test_quantize.py: LM logits with int8
# weights, and decode over an int8 KV cache against an fp cache).
INT8_OBJ_CORR = 0.98
INT8_LOGIT_CORR = 0.99
INT8_KV_CORR = 0.995
LM_INT8_SEQ, LM_INT8_STEPS = 2048, 32   # int8 prefill B=2 x 2048, decode
# Phase 5e: the paper's comparison (benchmarks/fig12_e2e.py's grid) in
# simulation, on a latency table measured on the card.
SIM_CAMERAS, SIM_FRAMES = 4, 30
SIM_BWS = (20e6, 40e6, 80e6)
SIM_SLOS = (0.5, 1.0, 1.5)
# Phase 5f: the registry's three detectors at full width, one SLO class
# each, on one camera a class.
MODEL_MAP = {"0.5": "vit_s16", "1.0": "efficientnet_b7", "2.0": "tangram"}
MODEL_FRAMES = 24
# Phase 5g: fleet sharding.  Three 2048x1024 cameras served as the serve
# driver's --cameras 3 --shards 2 serves them (cameras 0 and 2 on shard 0,
# camera 1 on shard 1: the trace has no camera rates), each shard's
# executor on its own CUDA stream; then 1,000 simulated cameras through
# four shards on a table profiled on the card.  SLO 0.5 s, as phase 4's
# tighter trace, so that each shard fires several invocations.
SHARD_CAMERAS, SHARD_FRAMES, SHARD_SLO, SHARDS = 3, 24, 0.5, 2
FLEET_CAMERAS, FLEET_SECONDS, FLEET_SHARDS = 1000, 60.0, 4
# Phase 8c: the vision and diffusion zoo at full width, seeded random
# weights drawn on the card, bf16, through K6 (impl="flash") and through
# its plain version (impl="torch").  The JAX package's shape cells
# (repro/config.py VISION_SHAPES, DIFFUSION_SHAPES): (arch, batch,
# resolution) and (arch, batch, resolution, sampler steps).
ZOO_SEED = 21
ZOO_VISION = (("vit-b16", 128, 224), ("deit-b", 128, 224),    # serve_b128
              ("deit-b", 64, 384),                            # cls_384
              ("vit-s16", 1, 224), ("vit-s16", 128, 224))     # serve_b1/128
ZOO_EFFNET = ("efficientnet-b7", 8, 600)                      # native 600^2
ZOO_DIT = (("dit-s2", 16, 512, 4), ("dit-xl2", 16, 512, 4))   # gen_fast
ZOO_DIT_1024 = ("dit-xl2", 4, 1024, 50)                       # gen_1024
#: K6 timed at one layer of ViT-B/16's serve_b128 and of DiT-XL/2's
#: gen_1024: (B, S, H, D)
ZOO_K6 = {"vit-b16": (128, 197, 12, 64), "dit-xl2": (4, 4096, 16, 72)}
# Classifier logits, kernels vs plain, row-scaled as phase 7 holds K6
# (ATTN_ROW_TOL), and top-1 equal wherever the plain top-2 margin exceeds
# that row's limit.  DiT: the first step's eps, max |got - want| over the
# RMS of the plain eps, and the sampler's final latents correlating above
# DIT_LATENT_CORR.
ZOO_ROW_TOL = ATTN_ROW_TOL["k6", torch.bfloat16]
DIT_EPS_TOL = ZOO_ROW_TOL
DIT_LATENT_CORR = 0.999

# Phase 8d: deepseek-moe-16b (arXiv:2401.06066: 28 layers, d 2048, 16
# query heads over 16 KV heads x 128, 64 routed experts top-6 and 2
# shared, experts of 1408, vocab 102400, bf16) at full width through the LM
# path, GShard dispatch at the published capacity factor 1.25 in groups of
# 512 tokens.
MOE_ARCH = "deepseek-moe-16b"
MOE_SEED = 22
MOE_FORCED, MOE_GREEDY = 64, 16  # teacher-forced, then greedy decode steps
MOE_NODROP_SEQ = 512             # the no-drop decode-vs-prefill prompt
MOE_INT8_SEQ = 2048
# Kernels vs plain: K6 and K7 round other than their plain versions, which
# moves a router's near-ties, and one moved choice moves a token's output
# by a whole expert's share and, past capacity, which token of its group
# drops; with random weights the differences compound over 28 layers
# (routing decisions equal 0.967 at layer 0, 0.299 at layer 27; as sets
# 0.995 and 0.754).  So each layer is also fed one input through both
# (no compounding), and the logits are held by statistics over every
# logit, not by a max.  Measured on an H100 80GB HBM3 at 700 W (PERF.md
# §6): each layer on one input, least routing agreement 0.9669 and
# largest output difference 0.0433 of its RMS (layer 0; later layers
# above 0.989 and below 0.02); compounded, least agreement as sets 0.7539;
# logits (corr, median |dlogit|, p99): kernels vs plain at worst 0.8838 /
# 0.3008 / 1.3574 (prefill last position; positions 0-63 0.9741 / 0.1289
# / 0.6895, decode 0.9946 / 0.0605 / 0.3164), no-drop decode vs prefill
# 0.9977 / 0.0381 / 0.2188, int8 vs bf16 prefill 0.9011 / 0.3003 /
# 1.1426.  Each limit is three times its reading (for a share or a
# correlation: three times its distance from 1).
MOE_ROUTE_AGREE = 0.90           # a layer on one input: decisions equal
MOE_LAYER_TOL = 0.13             # a layer on one input: output diff / RMS
MOE_ROUTE_SETS = 0.26            # compounded: least share as sets
MOE_LIMITS = {                   # (corr >=, median <=, p99 <=)
    "kernels vs plain": (0.65, 0.90, 4.1),
    "no-drop": (0.993, 0.115, 0.66),
    "int8": (0.70, 0.90, 3.43)}
# int8 weights: the bound of the JAX package's int8 LM test (logits
# correlation > 0.99, tests/test_quantize.py), held where routing cannot
# compound: each layer fed one input through the int8 and the bf16
# weights, its outputs correlating above it.  End to end the int8
# model's logits correlate 0.9011 with bf16's (above), where the JAX
# package's own MoE int8 test holds only the loss (within 8%).
MOE_INT8_CORR = 0.99


TRAIN_SEED = 23
TRAIN_REDUCED_BATCH = 4
TRAIN_LM_ARCH = LM_ARCH           # the reduced LM of phase 10(a)
TRAIN_LM_SHAPE = (2, 4096)        # B x S: "chunked" runs two chunks of 2048
TRAIN_SHAPE = "train_c32"         # tangram-detector's training cell
TRAIN_TIMED_STEPS = 6             # the step time: median of steps 1..5
TRAIN_STEPS = 12                  # the drill runs
TRAIN_CKPT_EVERY = 4
TRAIN_DRILL_AT = 9                # restores step 8, dropping its update
TRAIN_FIXED_STEPS = 20
TRAIN_OPT = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                    total_steps=10)
TRAIN_FULL_OPT = opt_lib.OptimizerConfig(lr=5e-4, warmup_steps=2,
                                         total_steps=TRAIN_FIXED_STEPS)
TRAIN_TOL = {"loss": 1e-5, "grads": 1e-4, "params": 1e-5}
TRAIN_IMPL_TOL = 1e-4             # "xla" vs "chunked" on the card

# Phase 11: the mesh.  One card, so the data-parallel split runs on a
# data=2 serve mesh laid over the card twice; the dry run's cells count,
# at DRYRUN_DEPTH layers, in one worker process a host CPU while (a) and
# (b) run.
DP_DATA = 2
DRYRUN_CELLS = ("serve_c1", "serve_c8")
DRYRUN_SEED = 24
DRYRUN_DEPTH = 2
#: phase 8a: consecutive positions one captured decode step is replayed at
CAPTURE_STEPS = 32
#: phase 12(a): the K4 rows' geometries at canvas 1024 (registry model,
#: patch, d: the detectors' trunks)
K4_GEOMETRIES = (("tangram", PATCH, D_MODEL), ("vit_s16", 16, 384),
                 ("efficientnet_b7", PATCH, 512))
#: phase 12(b): teacher-forced steps that fill the cache, then the steps
#: run with each cache write
MASKED_PREFIX, MASKED_STEPS = 32, 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ phase 1, 2 ----

def card_info() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def build_kernels() -> None:
    """Build every kernel library at once, one nvcc per source."""
    t0 = time.perf_counter()
    modules = (stitch_kernels, fused_embed, gmm_kernels, flash_kernels)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        for future in [pool.submit(mod.library) for mod in modules]:
            future.result()
    log(f"built {len(modules)} libraries in "
        f"{time.perf_counter() - t0:.2f}s")
    for mod in modules:
        info = _build.BUILDS[mod.LIBRARY]
        log(f"  {mod.LIBRARY}: nvcc {info['seconds']:.2f}s -> "
            f"{info['path']}")
        for line in info["log"].splitlines():
            entry = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)(I\w*?E)?",
                              line)
            if entry:   # the kernel's name and template arguments, mangled
                log(f"  ptxas: {entry.group(1)}{entry.group(2) or ''}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas:   {line.strip()}")


# ---------------------------------------------------------------- phase 3 ----

def packed_plan(sizes, seed: int, dtype: torch.dtype, device):
    """Packer-built plan + slots for patches of the given (w, h) sizes."""
    rng = np.random.default_rng(seed)
    patches = [Patch(0, 0, w, h, frame_id=i % 3)
               for i, (w, h) in enumerate(sizes)]
    canvases = stitch(patches, CANVAS, CANVAS)
    plan = build_batch_plan(patches, canvases, CANVAS, CANVAS)
    stitch_ops.check_records(plan)
    if dtype.is_floating_point:
        crops = [rng.normal(size=(p.h, p.w, 3)) for p in patches]
    else:
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        crops = [rng.integers(lo, hi, size=(p.h, p.w, 3)) for p in patches]
    slots = stitch_ops.pack_plan_host(
        [np.asarray(c, np.float32) for c in crops], plan)
    slots = torch.from_numpy(slots).to(device=device, dtype=dtype)
    records = torch.from_numpy(plan.records).to(device)
    return plan, slots, records


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


def row_scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest max_d |got - want| / rms_d(want) over the rows (all but
    the last axis) of an attention output."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / rms).max())


def plan_cases():
    """The plans both kernel checks run: random sizes, placements flush
    with the canvas edges, and an empty plan."""
    rng = np.random.default_rng(0)
    random_sizes = [(int(rng.integers(8, CANVAS // 2 + 1)),
                     int(rng.integers(8, CANVAS // 2 + 1)))
                    for _ in range(24)]
    # 4 x 512^2 tile a canvas exactly (placements flush with the right and
    # bottom edges), then a full canvas and a full-height strip
    flush_sizes = [(512, 512)] * 4 + [(1024, 1024), (320, 1024), (704, 16)]
    return [("random", random_sizes), ("edge-flush", flush_sizes),
            ("empty", [])]


def check_kernels(device) -> float:
    """K1/K2 vs their plain versions; returns the largest abs difference
    seen (required to be 0: the kernels are bit-exact copies)."""
    cases = plan_cases()
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
        for name, sizes in cases:
            plan, slots, records = packed_plan(sizes, 1, dtype, device)
            got = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                             impl="cuda")
            want = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                              impl="torch")
            back = stitch_ops.unstitch_patches(
                got, records, plan.slot_capacity, plan.hmax, plan.wmax,
                impl="cuda")
            back_ref = stitch_ops.unstitch_patches(
                want, records, plan.slot_capacity, plan.hmax, plan.wmax,
                impl="torch")
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want), max_abs_err(back, back_ref))
            worst = max(worst, err)
            ok = (got.shape == want.shape and torch.equal(got, want)
                  and back.shape == back_ref.shape
                  and torch.equal(back, back_ref)
                  and torch.equal(back[:plan.num_patches],
                                  slots[:plan.num_patches]))
            log(f"  {str(dtype):15s} {name:10s} B={plan.num_canvases} "
                f"K={plan.slots_per_canvas} slots={plan.slot_capacity}x"
                f"{plan.hmax}x{plan.wmax}: {'bit-exact' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"kernel differs from plain version: "
                                     f"{dtype} {name}, max abs err {err}")
    return worst


#: K1 edge cases: (B, M, N, K, hmax, wmax, P), as in tests/test_torch_cuda.py
K1_EDGES = {"odd-rows": (2, 37, 45, 12, 20, 24, 6),
            "row-tiles": (3, 1024, 1024, 64, 256, 512, 40),
            "overlap": (2, 256, 256, 64, 128, 128, 16),
            "2048-records": (1, 1024, 1024, 2048, 64, 64, 32)}


def random_records(rng, b, k, m, n, hmax, wmax, p, valid=0.85):
    """Placements at random inside the canvas (overlapping, edges at any
    offset), slots drawn with repeats below ``p``, some records invalid."""
    w = rng.integers(1, wmax + 1, size=(b, k))
    h = rng.integers(1, hmax + 1, size=(b, k))
    x = rng.integers(0, n - w + 1)
    y = rng.integers(0, m - h + 1)
    ok = (rng.random((b, k)) < valid).astype(np.int64)
    slot = rng.integers(0, p, size=(b, k))
    return np.stack([ok, slot, x, y, w, h], -1).astype(np.int32)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def check_k1_edges(device) -> None:
    """K1 alone, bit-exact, on the cases its plan and owner map risk, and
    through its C entry on outputs filled with 0xFF bytes."""
    rng = np.random.default_rng(31)
    for name, (b, m, n, k, hmax, wmax, p) in K1_EDGES.items():
        records = torch.from_numpy(random_records(
            rng, b, k, m, n, hmax, wmax, p)).to(device)
        for dtype in (torch.float32, torch.bfloat16, torch.int8,
                      torch.uint8):
            for c in (1, 3, 4):
                if dtype.is_floating_point:
                    host = rng.normal(size=(p, hmax, wmax, c))
                else:
                    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
                    host = rng.integers(lo, hi, size=(p, hmax, wmax, c))
                slots = torch.from_numpy(host.astype(np.float32)).to(
                    device, dtype)
                got = stitch_ops.stitch_canvases(slots, records, m, n,
                                                 impl="cuda")
                want = stitch_ops.stitch_canvases(slots, records, m, n,
                                                  impl="torch")
                plan = stitch_kernels.stitch_plan(b, m, n, c,
                                                  slots.element_size())
                filled = torch.empty_like(want)
                as_bytes(filled).fill_(0xFF)
                rc = stitch_kernels.library().tangram_stitch(
                    slots.data_ptr(), records.data_ptr(), filled.data_ptr(),
                    hmax, wmax, c, b, k, m, n, slots.element_size(), *plan,
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if rc != 0 or not (
                        torch.equal(as_bytes(got), as_bytes(want))
                        and torch.equal(as_bytes(filled), as_bytes(want))):
                    raise AssertionError(
                        f"K1 differs from its plain version: {name} {dtype} "
                        f"C={c} (entry rc {rc}), max abs err "
                        f"{max_abs_err(got, want)}")
        log(f"  K1 {name:12s} B={b} {m}x{n} K={k}, 4 dtypes x C 1/3/4, "
            f"plan (rows, group, store, smem) at C=3 f32 "
            f"{stitch_kernels.stitch_plan(b, m, n, 3, 4)}: bit-exact, "
            f"0xFF-filled entry bit-exact")


# --------------------------------------------------------------- phase 3b ----

def decoded_centres(raw: torch.Tensor, patch: int):
    """(cx, cy) of every cell, by the plain decode math."""
    side_m, side_n = raw.shape[1:3]
    gy, gx = torch.meshgrid(
        torch.arange(side_m, dtype=torch.float32, device=raw.device),
        torch.arange(side_n, dtype=torch.float32, device=raw.device),
        indexing="ij")
    r = raw.float()
    return ((gx + torch.sigmoid(r[..., 1])) * patch,
            (gy + torch.sigmoid(r[..., 2])) * patch)


def compare_k3(grids, plain, raw, records: np.ndarray, patch: int):
    """K3 vs its plain version: hit masks equal except at cells whose
    decoded centre lies within 1e-4 px of a placement edge (counted), and
    every other value within 1e-5 abs/rel.  Returns (max abs err, edge
    cells)."""
    differ = (grids[..., 0] > 0) != (plain[..., 0] > 0)
    edge = 0
    if differ.any():
        cx, cy = decoded_centres(raw, patch)
        where = {int(r[1]): (bi, *map(int, r[2:]))
                 for bi, per in enumerate(records) for r in per if r[0] > 0}
        for slot, gy, gx in differ.nonzero().tolist():
            bi, x, y, w, h = where[slot]
            cxv, cyv = float(cx[bi, gy, gx]), float(cy[bi, gy, gx])
            dist = min(abs(cxv - x), abs(cxv - x - w), abs(cyv - y),
                       abs(cyv - y - h))
            if dist > 1e-4:
                raise AssertionError(f"K3 hit masks differ at slot {slot} "
                                     f"cell ({gy}, {gx}), {dist} px from "
                                     f"the placement's edges")
            edge += 1
    keep = (~differ)[..., None]
    got, want = grids * keep, plain * keep
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        raise AssertionError(f"K3 differs from its plain version: max abs "
                             f"err {max_abs_err(got, want)}")
    return max_abs_err(got, want), edge


def check_fused_kernels(device) -> dict:
    """K4/K3 vs their plain versions on the K1/K2 plans and an all-invalid
    one; returns the largest abs errors seen per kernel and weight dtype."""
    rng = np.random.default_rng(3)
    k_dim = PATCH * PATCH * 3
    weights = rng.normal(size=(k_dim, D_MODEL)).astype(np.float32)
    weights /= np.sqrt(k_dim)
    bias = rng.normal(size=(D_MODEL,)).astype(np.float32)
    cases = plan_cases()
    cases.append(("all-invalid", cases[0][1]))
    worst = {"stitch_embed_float32": 0.0, "stitch_embed_bfloat16": 0.0,
             "unstitch_decode": 0.0}
    edge_cells = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, sizes in cases:
        plan, slots, records = packed_plan(sizes, 1, torch.float32, device)
        if name == "all-invalid":
            records = records.clone()
            records[..., 0] = 0
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            kernel = torch.from_numpy(weights).to(device, dtype)
            b = torch.from_numpy(bias).to(device, dtype)
            got = stitch_ops.stitch_embed(slots, records, kernel, b, CANVAS,
                                          CANVAS, PATCH, impl="cuda")
            want = stitch_ops.stitch_embed(slots, records, kernel, b,
                                           CANVAS, CANVAS, PATCH,
                                           impl="torch")
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            key = f"stitch_embed_{str(dtype).split('.')[-1]}"
            worst[key] = max(worst[key], err)
            ok = (got.shape == want.shape and got.dtype == dtype
                  and torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            if name == "all-invalid":
                ok = ok and torch.equal(got, b.expand_as(got))
            log(f"  K4 {str(dtype):15s} {name:11s} B={plan.num_canvases} "
                f"K={plan.slots_per_canvas}: max abs err {err:.3g} "
                f"(tol {tol:g}) {'ok' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"K4 differs from its plain version: "
                                     f"{dtype} {name}, max abs err {err}")
            side = CANVAS // PATCH
            raw = torch.from_numpy(rng.normal(
                size=(plan.num_canvases, side, side, 5)).astype(
                    np.float32)).to(device, dtype)
            grids = stitch_ops.unstitch_decode(raw, records, PATCH,
                                               plan.slot_capacity,
                                               impl="cuda")
            plain = stitch_ops.unstitch_decode(raw, records, PATCH,
                                               plan.slot_capacity,
                                               impl="torch")
            torch.cuda.synchronize()
            err, edge = compare_k3(grids, plain, raw, records.cpu().numpy(),
                                   PATCH)
            worst["unstitch_decode"] = max(worst["unstitch_decode"], err)
            edge_cells += edge
            log(f"  K3 raw {str(dtype):11s} {name:11s}: max abs err "
                f"{err:.3g}, {int((plain[..., 0] > 0).sum())} cells kept, "
                f"{edge} edge cells excused")
    log(f"  K3 hit masks: {edge_cells} cells excused as within 1e-4 px of "
        f"a placement edge")
    worst["unstitch_decode"] = max(worst["unstitch_decode"],
                                   check_k3_edges(device))
    return worst


def check_k3_edges(device) -> float:
    """K3 at patch 32 on 3 canvases of 64 records: slots named twice (the
    last valid record wins), the last 10 of 120 slots never named,
    placement edges at any pixel, a third of the centre logits at +-30;
    32^2 cells (16-byte stores) and 33^2 (scalar stores), f32 and bf16
    raw heads, through the wrapper and through the C entry on an output
    filled with 0xFF bytes.  Returns the largest abs error."""
    rng = np.random.default_rng(41)
    b, k, cap = 3, 64, 120
    worst = 0.0
    for side in (32, 33):
        m = side * PATCH
        records = random_records(rng, b, k, m, m, m // 2, m // 2, cap - 10)
        rec = torch.from_numpy(records).to(device)
        raw = rng.normal(size=(b, side, side, 5)).astype(np.float32)
        sat = rng.random((b, side, side, 2)) < 1 / 3
        raw[..., 1:3] = np.where(sat, rng.choice([-30.0, 30.0], sat.shape),
                                 raw[..., 1:3])
        for dtype in (torch.float32, torch.bfloat16):
            r = torch.from_numpy(raw).to(device, dtype)
            got = stitch_ops.unstitch_decode(r, rec, PATCH, cap, impl="cuda")
            want = stitch_ops.unstitch_decode(r, rec, PATCH, cap,
                                              impl="torch")
            filled = torch.empty_like(want)
            as_bytes(filled).fill_(0xFF)
            rc = fused_embed.library().tangram_unstitch_decode(
                r.data_ptr(), rec.data_ptr(), filled.data_ptr(), b, k, side,
                side, cap, PATCH, int(dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            err = max(max_abs_err(got, want), max_abs_err(filled, want))
            worst = max(worst, err)
            ok = (rc == 0 and torch.equal(got[..., 0] > 0, want[..., 0] > 0)
                  and torch.allclose(got, want, atol=1e-5, rtol=1e-5)
                  and torch.isfinite(filled).all()
                  and torch.allclose(filled, want, atol=1e-5, rtol=1e-5)
                  and not got[cap - 10:].any())
            log(f"  K3 {side}x{side} cells, {str(dtype):14s}: duplicates, "
                f"10 unnamed slots, +-30 centres: max abs err {err:.3g}, "
                f"0xFF-filled entry {'ok' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"K3 differs from its plain version on "
                                     f"its edge cases: {side}^2 {dtype} "
                                     f"(entry rc {rc}), max abs err {err}")
    return worst


# --------------------------------------------------------------- phase 3c ----

def gmm_case(kind: str, h: int, w: int, rng, device):
    """A mixture state and a frame on the card: ``random`` (normalised
    weights, half the pixels near one component's mean) or ``ties``
    (cycling over the pixels: equal weights and variances with x == mu;
    equal weights with nothing matched; a 2-way fitness tie behind an
    unmatched heavier component; equal weights, x == mu, unequal
    variances)."""
    n = h * w
    if kind == "random":
        wt = rng.random((n, 3)).astype(np.float32) + 0.01
        wt /= wt.sum(axis=1, keepdims=True)
        mu = rng.random((n, 3)).astype(np.float32)
        var = rng.uniform(1e-4, 0.05, (n, 3)).astype(np.float32)
        near = mu[np.arange(n), rng.integers(0, 3, n)]
        x = np.where(rng.random(n) < 0.5, near + rng.normal(0, 0.05, n),
                     rng.random(n)).astype(np.float32)
    else:
        k = np.arange(n) % 4
        x = np.linspace(0.1, 0.9, n, dtype=np.float32)
        wt = np.full((n, 3), np.float32(1) / np.float32(3), np.float32)
        mu = np.repeat(x[:, None], 3, axis=1)
        var = np.full((n, 3), 0.04, np.float32)
        mu[k == 1] += 2.0
        wt[k == 2] = np.array([0.5, 0.25, 0.25], np.float32)
        mu[k == 2, 0] += 0.6
        var[k == 3] = np.array([0.04, 0.01, 0.09], np.float32)
    state = gmm_ops.state_from_numpy(
        {"w": wt.reshape(h, w, 3), "mu": mu.reshape(h, w, 3),
         "var": var.reshape(h, w, 3)}, device)
    return state, torch.from_numpy(x.reshape(h, w)).to(device)


def compare_gmm(got, fg, want, fg_plain, what: str, worst: dict) -> None:
    """K5 against its plain version: w, mu, var and the mask bit-equal.
    Prints the largest difference and the count of differing mask
    pixels, and keeps both in ``worst``."""
    err = max(max_abs_err(got[k], want[k]) for k in GMM_KEYS)
    n_mask = int((fg != fg_plain).sum())
    ok = (fg.dtype == torch.bool
          and all(torch.equal(got[k], want[k]) for k in GMM_KEYS)
          and torch.equal(fg, fg_plain))
    worst["max_abs_err"] = max(worst["max_abs_err"], err)
    worst["mask_pixels"] += n_mask
    worst["cases"] += 1
    log(f"  K5 {what}: max abs diff {err:.3g}, {n_mask} mask pixels differ, "
        f"foreground {float(fg.float().mean()):.4f} "
        f"{'bit-equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError(f"K5 differs from its plain version: {what}")


def check_gmm(device):
    """Phase 3c.  Returns (worst, the scene's float frames, its final
    state)."""
    worst = {"max_abs_err": 0.0, "mask_pixels": 0, "cases": 0}
    scene = Scene(preset(0, width=CAM_W, height=CAM_H))
    frames = []
    got = want = gmm_core.init_state(CAM_H, CAM_W, device=device)
    for i in range(EDGE_FRAMES):
        scene.step()
        frames.append(scene.render())
        x = torch.from_numpy(frames[-1]).to(device)
        got, fg = gmm_ops.gmm_update(got, x, impl="cuda")
        want, fg_plain = gmm_ops.gmm_update(want, x, impl="torch")
        torch.cuda.synchronize()
        compare_gmm(got, fg, want, fg_plain,
                    f"4K scene frame {i:2d} ({CAM_W}x{CAM_H})", worst)
    rng = np.random.default_rng(5)
    for kind in ("random", "ties"):
        for h, w in ((1, 1), (7, 13), (CAM_H, CAM_W)):
            state, x = gmm_case(kind, h, w, rng, device)
            got, fg = gmm_ops.gmm_update(state, x, impl="cuda")
            want, fg_plain = gmm_ops.gmm_update(state, x, impl="torch")
            torch.cuda.synchronize()
            compare_gmm(got, fg, want, fg_plain, f"{kind} {h}x{w}", worst)
    # why the plain version folds its sums in index order: how often
    # PyTorch's sum over the 3 components disagrees with that fold here
    state, _ = gmm_case("random", CAM_H, CAM_W, rng, device)
    w = state["w"] * 3.7
    folded = (w[..., 0] + w[..., 1]) + w[..., 2]
    log(f"  torch.sum over 3 components vs the index-order fold on this "
        f"card: {int((w.sum(dim=-1) != folded).sum())} of {folded.numel()} "
        f"pixels differ")
    return worst, frames, got


# ---------------------------------------------------------------- timing ----

def time_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 3) -> float:
    """Time of one call: ``iters`` calls back to back between two CUDA
    events, divided by ``iters``; the median over ``windows`` such
    windows.  The host enqueues each call while the card runs the one
    before, so host time enters wherever a call's host work outlasts its
    device work: this is the time of a call, not of the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int = 20, windows: int = 3) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA
    graph, its replay timed between two CUDA events and divided by
    ``iters``; the median over ``windows`` replays.  No host work enters;
    the gaps the card leaves between the graph's kernels do."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


def profiler_ms(fn, iters: int = 20):
    """Device time of one call as ``torch.profiler`` records it: the
    durations of the device activities (kernels, copies, fills) of
    ``iters`` calls, summed and divided by ``iters``; None if it records
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    return sum(e.time_range.elapsed_us() for e in device) / 1e3 / iters


def timed(fn, iters: int = 20, warmup: int = 3) -> dict:
    """A kernel's (or a library call's) times: ``ms_call`` (CUDA events
    around back-to-back calls, host work included), ``ms_device`` (a CUDA
    graph of the same calls: the card's time alone) and
    ``ms_device_profiler`` (``torch.profiler``'s sum of its device
    activities, the cross-check)."""
    return {"ms_call": time_ms(fn, iters=iters, warmup=warmup),
            "ms_device": graph_ms(fn, iters),
            "ms_device_profiler": profiler_ms(fn, iters)}


def device_keys(t: dict, suffix: str = "") -> dict:
    """The keys a kernel row adds for one timing; a nested timing (K7's at
    a device pos, ``"tensor_pos"``) as ``{key}_tensor_pos{suffix}``."""
    out = {}
    for key, value in t.items():
        if isinstance(value, dict):
            out.update(device_keys(value, f"_{key}{suffix}"))
        else:
            out[f"{key}{suffix}"] = value
    return out


def fmt_times(t: dict) -> str:
    prof = t["ms_device_profiler"]
    return (f"device {t['ms_device']:.4f} ms (profiler "
            f"{'not recorded' if prof is None else f'{prof:.4f} ms'}), "
            f"call {t['ms_call']:.4f} ms")


def placed_elements(plan) -> int:
    r = plan.records[plan.records[..., 0] > 0]
    return int((r[:, 4] * r[:, 5]).sum()) * 3


def kernel_rows(plan, slots, records, launches, worst) -> list:
    """Time K1/K2 on one plan; bound = bytes moved / HBM rate."""
    e = slots.element_size()
    m = n = CANVAS
    rec_bytes = records.numel() * 4
    canvases = stitch_ops.stitch_canvases(slots, records, m, n)
    placed = placed_elements(plan) * e
    rows = []
    for name, replaces, kern, plain, out_bytes in (
            ("stitch", "src/repro/kernels/stitch/stitch.py:73",
             lambda: stitch_ops.stitch_canvases(slots, records, m, n,
                                                impl="cuda"),
             lambda: stitch_ops.stitch_canvases(slots, records, m, n,
                                                impl="torch"),
             canvases.numel() * e),
            ("unstitch", "src/repro/kernels/stitch/stitch.py:132",
             lambda: stitch_ops.unstitch_patches(
                 canvases, records, plan.slot_capacity, plan.hmax,
                 plan.wmax, impl="cuda"),
             lambda: stitch_ops.unstitch_patches(
                 canvases, records, plan.slot_capacity, plan.hmax,
                 plan.wmax, impl="torch"),
             plan.slot_capacity * plan.hmax * plan.wmax * 3 * e)):
        before = dict(LAUNCHES)
        plain_ms = time_ms(plain)
        t = timed(kern)
        LAUNCHES.update(before)   # timing launches not counted
        moved = rec_bytes + placed + out_bytes
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/stitch/csrc/stitch.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst, "ms": t["ms_call"], "plain_ms": plain_ms,
            "bound_ms": moved / H100.hbm_bw * 1e3, "bound_by": "bytes",
            "library_ms": None, **device_keys(t)})
        if name == "stitch":
            rows[-1]["redesigned"] = "owner map, warp spans, 16-byte stores"
        log(f"  {name}: {fmt_times(t)} (plain {plain_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB) at "
            f"B={plan.num_canvases} K={plan.slots_per_canvas} "
            f"slots={plan.slot_capacity}x{plan.hmax}x{plan.wmax}")
    return rows


# ------------------------------------------------------------ phase 4, 5 ----

def make_trace(device, n_frames: int, slo: float, gmm_impl=None):
    """Run the edge pipeline once on the card (K5, or the plain GMM with
    ``gmm_impl="torch"``); keep its arrivals, the frames it shipped and
    the launches it made, so every serve run replays the same trace."""
    frames = {}

    def sink(frame_id, rgb, n_patches):
        frames[frame_id] = (rgb, n_patches)

    cam = make_source("synthetic", n_frames=n_frames, canvas=CANVAS,
                      slo=slo, frame_sink=sink, device=device,
                      gmm_impl=gmm_impl)
    reset_launches()
    t0 = time.perf_counter()
    arrivals = list(cam.events(None))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"  edge pipeline ({gmm_impl or 'K5'}): {n_frames} frames of "
        f"{2 * CANVAS}x{CANVAS} -> {len(arrivals)} patches in "
        f"{time.perf_counter() - t0:.2f}s, launches {launches}")
    return arrivals, frames, launches


def arrival_key(a):
    p = a.patch
    return (a.t_arrive, a.n_bytes, p.x0, p.y0, p.x1, p.y1, p.frame_id,
            p.camera_id, p.t_gen, p.slo)


def same_arrivals(a, b, what: str) -> None:
    if len(a) != len(b) or any(arrival_key(x) != arrival_key(y)
                               for x, y in zip(a, b)):
        raise AssertionError(f"{what}: arrivals differ ({len(a)} vs "
                             f"{len(b)})")


def same_trace(kern, plain, what: str) -> None:
    """Equal arrivals (patch geometry, frame_id, t_gen, t_arrive) and
    equal shipped frames (pixels and patch counts)."""
    (a_k, f_k, _), (a_p, f_p, _) = kern, plain
    same_arrivals(a_k, a_p, what)
    if set(f_k) != set(f_p) or any(
            f_k[f][1] != f_p[f][1] or not np.array_equal(f_k[f][0], f_p[f][0])
            for f in f_k):
        raise AssertionError(f"{what}: shipped frames differ")
    log(f"  {what}: {len(a_k)} arrivals and {len(f_k)} frames equal")


def trace_source(arrivals, frames):
    """``source_fn`` for :func:`serve_run`: the frames registered up
    front, the arrivals replayed."""
    def make(ex):
        for frame_id, (rgb, n_patches) in frames.items():
            ex.add_frame(frame_id, rgb, n_patches)
        return make_source("trace", arrivals=arrivals)
    return make


class RecordingSource:
    """Hands a source's arrivals to the engine and keeps them."""

    def __init__(self, source):
        self.source = source
        self.arrivals = []

    def events(self, engine):
        for a in self.source.events(engine):
            self.arrivals.append(a)
            yield a

    def stats(self):
        return self.source.stats()


def pack_canvases(patches, frames, device) -> torch.Tensor:
    """``patches`` (with their frames' pixels) packed and stitched onto
    canvases on the card by the plain stitch."""
    plan = build_batch_plan(patches, stitch(patches, CANVAS, CANVAS),
                            CANVAS, CANVAS)
    crops = [frames[p.frame_id][0][p.y0:p.y1, p.x0:p.x1] for p in patches]
    slots = torch.from_numpy(stitch_ops.pack_plan_host(crops, plan)).to(
        device)
    records = torch.from_numpy(plan.records).to(device)
    return stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS,
                                      impl="torch")


def calibrate_head(build, arrivals, frames, device) -> None:
    """Random weights leave the head's objectness logits in a narrow band
    below 0, and where the band lies moves with a canvas's content, so
    the full-width trunk routes nothing at threshold 0.5.  Pack the
    trace's own patches, all of them and each quarter of the trace, into
    probe canvases, and shift the objectness bias so that at least a
    quarter of the cells of every probe canvas clear the threshold: the
    serve runs then route detections to compare, in small invocations
    too."""
    cfg, params, _ = build
    patches = [a.patch for a in arrivals]
    q = -(-len(patches) // 4)
    groups = [patches] + [patches[i:i + q]
                          for i in range(0, len(patches), q)]
    logits = []
    with torch.inference_mode():
        for group in groups:
            canvases = pack_canvases(group, frames, device)
            out = detector_lib.forward(cfg, params, canvases)
            logits.append(out[..., 0].float().flatten(1))
    logits = torch.cat(logits)
    shift = float(logits.quantile(0.75, dim=1).min())
    params["det_head"]["bias"][0] -= shift
    log(f"  objectness bias shifted by {-shift:.4f} ({logits.shape[0]} "
        f"probe canvases, logits {float(logits.min()):.4f}.."
        f"{float(logits.max()):.4f})")


def serve_run(name: str, impl, build, table, source_fn, device,
              fuse: bool = False, mesh=None):
    """One full serve of the source ``source_fn(executor)`` builds; returns
    what the run routed, its arrivals, and the detector head outputs of
    every call of the trunk ((obj, boxes) unfused, the raw head fused:
    one an invocation, or one a ``data`` chunk on a serve ``mesh``)."""
    cfg, params, serve_fn = build
    config = ServeConfig(max_canvases=4, executor=name, fuse=fuse)
    heads = []

    def recording_serve_fn(p, canvases):
        obj, boxes = serve_fn(p, canvases)
        heads.append((obj, boxes))
        return obj, boxes

    fused = fused_kwargs(cfg, params) if fuse else {}
    if fuse:
        tokens_fn = fused["tokens_fn"]

        def recording_tokens_fn(p, tokens):
            raw = tokens_fn(p, tokens)
            heads.append((raw,))
            return raw

        fused["tokens_fn"] = recording_tokens_fn
    ex = make_executor(name, serve_fn=recording_serve_fn, params=params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       impl=impl, max_inflight=config.max_inflight,
                       mesh=mesh, **fused)
    outputs = {}        # id(invocation) -> (per-frame dets, pixels)
    release = ex.on_complete

    def on_complete(comp):
        outputs[id(comp.invocation)] = comp.outputs
        release(comp)

    ex.on_complete = on_complete
    source = RecordingSource(source_fn(ex))
    engine = ServingEngine(uniform_pool(CANVAS, CANVAS, table,
                                        max_canvases=config.max_canvases),
                           ex)
    reset_launches()
    t0 = time.perf_counter()
    engine.serve(source)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # merge in invocation order: measured wall times may deliver two
    # completions in either order
    routed, pixels = {}, {}
    for inv in engine.invocations:
        per_frame, per_frame_pixels = outputs[id(inv)]
        for fid, dets in per_frame.items():
            routed.setdefault(fid, []).extend(dets)
        for fid, px in per_frame_pixels.items():
            pixels.setdefault(fid, []).extend(px)
    n_data = mesh.shape["data"] if mesh is not None else 1
    log(f"  [{name}, {impl or 'kernels'}] "
        + summary_line(engine, ex, source.stats(), config, wall, n_data))
    heads = [tuple(t.float().cpu().numpy() for t in h) for h in heads]
    obj = [1 / (1 + np.exp(-h[0][..., 0])) if fuse else h[0]
           for h in heads]
    hit = np.mean(np.concatenate([o.ravel() for o in obj]) >= 0.5)
    log(f"    launches {launches}, canvases per invocation "
        f"{[len(inv.canvases) for inv in engine.invocations]}, "
        f"{hit:.3f} of head cells at objectness >= 0.5")
    if len(ex.frames) != 0:
        raise AssertionError(f"{len(ex.frames)} frames still held")
    bounds = [[(p.frame_id, p.x0, p.y0) for p in inv.patches]
              for inv in engine.invocations]
    return {"routed": routed, "pixels": pixels, "launches": launches,
            "bounds": bounds, "invocations": engine.invocations,
            "heads": heads, "arrivals": source.arrivals,
            "n_sharded": ex.n_sharded}


def margin_filter(per_frame, threshold=0.5, margin=1e-3):
    """Drop detections within ``margin`` of the threshold."""
    out = {}
    for fid, dets in per_frame.items():
        kept = [(s, b) for s, b in dets if abs(s - threshold) >= margin]
        if kept:
            out[fid] = kept
    return out


def same_bounds_and_evidence(a: dict, b: dict, what: str) -> None:
    if a["bounds"] != b["bounds"]:
        raise AssertionError(f"{what}: invocation boundaries differ")
    if set(a["pixels"]) != set(b["pixels"]) or any(
            len(a["pixels"][f]) != len(b["pixels"][f])
            or not all(np.array_equal(x, y)
                       for x, y in zip(a["pixels"][f], b["pixels"][f]))
            for f in a["pixels"]):
        raise AssertionError(f"{what}: evidence pixels differ")


def same_result(a: dict, b: dict, what: str) -> None:
    same_bounds_and_evidence(a, b, what)
    ra, rb = margin_filter(a["routed"]), margin_filter(b["routed"])
    if set(ra) != set(rb):
        raise AssertionError(f"{what}: routed frames differ")
    for fid in ra:
        if len(ra[fid]) != len(rb[fid]):
            raise AssertionError(f"{what}: frame {fid} detection counts "
                                 f"{len(ra[fid])} != {len(rb[fid])}")
        for (sa, ba), (sb, bb) in zip(ra[fid], rb[fid]):
            if abs(sa - sb) > 1e-4 or max(
                    abs(x - y) for x, y in zip(ba, bb)) > 1e-3:
                raise AssertionError(f"{what}: frame {fid} detections "
                                     f"differ: {(sa, ba)} vs {(sb, bb)}")
    # the same trunk on bit-equal inputs: the head outputs must be equal
    # to the bit, which also holds K1's zero fill at the main path's shapes
    if len(a["heads"]) != len(b["heads"]) or not all(
            all(np.array_equal(x, y) for x, y in zip(ha, hb))
            for ha, hb in zip(a["heads"], b["heads"])):
        raise AssertionError(f"{what}: head outputs differ")
    n = sum(len(v) for v in ra.values())
    log(f"  {what}: {len(a['bounds'])} invocations, {n} routed detections "
        f"equal, evidence pixels and head outputs bit-equal")


def match_detections(a: dict, b: dict, score_tol: float, box_tol: float):
    """Pair each detection of ``a`` with an unused one of ``b`` in the same
    frame, score within ``score_tol`` and box within ``box_tol`` px.
    Returns (matched, unmatched ones within score_tol of 0.5, the other
    unmatched ones)."""
    matched, excused, bad = 0, 0, []
    for fid, dets in a.items():
        free = list(b.get(fid, []))
        for score, box in dets:
            hit = next((i for i, (s, bx) in enumerate(free)
                        if abs(s - score) <= score_tol and max(
                            abs(x - y) for x, y in zip(box, bx)) <= box_tol),
                       None)
            if hit is not None:
                free.pop(hit)
                matched += 1
            elif abs(score - 0.5) <= score_tol:
                excused += 1
            else:
                bad.append((fid, score, box))
    return matched, excused, bad


def patches_of(run: dict) -> list:
    """Each invocation's detector patch (``run["patch"]`` in a multi-model
    run, else the main path's)."""
    return run.get("patch") or [PATCH] * len(run["invocations"])


def decoded_grid_diffs(a: dict, b: dict):
    """Both runs' raw heads decoded by the plain K3 per invocation: the
    largest score and box differences over cells both keep at 0.5."""
    d_score = d_box = 0.0
    for inv, patch, (ra,), (rb,) in zip(a["invocations"], patches_of(a),
                                        a["heads"], b["heads"]):
        rec = torch.from_numpy(inv.batch_plan().records)
        ga, gb = (stitch_ops.unstitch_decode_reference(
            torch.from_numpy(r), rec, patch, len(inv.patches))
            for r in (ra, rb))
        both = (ga[..., 0] >= 0.5) & (gb[..., 0] >= 0.5)
        if both.any():
            diff = (ga - gb).abs()[both]
            d_score = max(d_score, float(diff[:, 0].max()))
            d_box = max(d_box, float(diff[:, 1:].max()))
    return d_score, d_box


def kept_by_one_run(a: dict, b: dict, what: str):
    """Cells that one fused run keeps (claimed by a placement, objectness
    >= 0.5) and the other does not, from both runs' raw heads decoded by
    the plain K3.  Each must have its score within SCORE_TOL of 0.5 in a
    run that claims it in both, or its decoded centre within EDGE_TOL px
    (scaled to the invocation's patch) of its placement's edge in either
    run.  Returns the counts (kept by ``a`` only, kept by ``b`` only)."""
    only = [0, 0]
    for inv, patch, (ra,), (rb,) in zip(a["invocations"], patches_of(a),
                                        a["heads"], b["heads"]):
        records = inv.batch_plan().records
        raws = [torch.from_numpy(r) for r in (ra, rb)]
        ga, gb = (stitch_ops.unstitch_decode_reference(
            r, torch.from_numpy(records), patch, len(inv.patches))
            for r in raws)
        edge_tol = EDGE_TOL * patch / PATCH
        keep_a, keep_b = ga[..., 0] >= 0.5, gb[..., 0] >= 0.5
        differ = keep_a != keep_b
        if not differ.any():
            continue
        where = {int(r[1]): (bi, *map(int, r[2:]))
                 for bi, per in enumerate(records) for r in per if r[0] > 0}
        centres = [decoded_centres(r, patch) for r in raws]
        for slot, gy, gx in differ.nonzero().tolist():
            sa, sb = float(ga[slot, gy, gx, 0]), float(gb[slot, gy, gx, 0])
            bi, x, y, w, h = where[slot]
            dist = min(min(abs(cx - x), abs(cx - x - w), abs(cy - y),
                           abs(cy - y - h))
                       for cx, cy in ((float(c[0][bi, gy, gx]),
                                       float(c[1][bi, gy, gx]))
                                      for c in centres))
            near_threshold = (sa > 0 and sb > 0
                              and min(abs(sa - 0.5), abs(sb - 0.5))
                              <= SCORE_TOL)
            if not near_threshold and dist > edge_tol:
                raise AssertionError(
                    f"{what}: slot {slot} cell ({gy}, {gx}) kept by one run "
                    f"only, scores {sa:.4f} / {sb:.4f}, centre {dist:.3f} px "
                    f"from its placement's edge")
            only[0 if keep_a[slot, gy, gx] else 1] += 1
    return only


def compare_fused(kern: dict, plain: dict, what: str) -> None:
    """Fused kernel run vs fused plain run: raw heads within RAW_TOL, the
    decoded cells both keep within SCORE_TOL / BOX_TOL, cells kept by one
    run only explained (:func:`kept_by_one_run`), and every routed
    detection paired within SCORE_TOL / BOX_TOL, or within SCORE_TOL of
    0.5, but for at most one per cell kept by its run only."""
    raw_err = max(float(np.abs(ha[0] - hb[0]).max())
                  for ha, hb in zip(kern["heads"], plain["heads"]))
    d_score, d_box = decoded_grid_diffs(kern, plain)
    log(f"  {what}: raw head max abs diff {raw_err:.4g} (tol {RAW_TOL}), "
        f"decoded score {d_score:.4g} (tol {SCORE_TOL}), box {d_box:.4g} px "
        f"(tol {BOX_TOL})")
    if raw_err > RAW_TOL or d_score > SCORE_TOL or d_box > BOX_TOL:
        raise AssertionError(f"{what}: outside the stated tolerances")
    only = kept_by_one_run(kern, plain, what)
    total, excused, unpaired = 0, 0, []
    for (x, y), allowed in zip(((kern, plain), (plain, kern)), only):
        matched, exc, bad = match_detections(x["routed"], y["routed"],
                                             SCORE_TOL, BOX_TOL)
        if len(bad) > allowed:
            raise AssertionError(f"{what}: {len(bad)} detections without a "
                                 f"partner ({allowed} cells kept by one "
                                 f"run only), e.g. {bad[:3]}")
        total += matched + exc
        excused += exc
        unpaired.append(len(bad))
    log(f"  {what}: {total // 2} routed detections paired both ways, "
        f"{excused} excused as within {SCORE_TOL} of 0.5; cells kept by "
        f"one run only {only[0]} / {only[1]} (score within {SCORE_TOL} of "
        f"0.5 or centre within {EDGE_TOL} px of a placement edge), "
        f"detections without a partner {unpaired[0]} / {unpaired[1]}")


def fused_agreement(fused: dict, unfused: dict) -> float:
    """Share of the fused run's detections with a partner in the unfused
    run under the fused rule (not gated: the two round bf16 at different
    places)."""
    matched, _, _ = match_detections(fused["routed"], unfused["routed"],
                                     SCORE_TOL, BOX_TOL)
    n = sum(len(v) for v in fused["routed"].values())
    return matched / n if n else 1.0


def check_launches(run: dict, kernels: tuple, what: str) -> None:
    """``kernels`` launched at least once in the run, every other kernel
    not at all."""
    ok = all((run["launches"][k] > 0) == (k in kernels)
             for k in run["launches"])
    if not ok:
        raise AssertionError(f"{what}: launches {run['launches']}, "
                             f"expected {kernels} only")


# ------------------------------------------------------------ phase 5c-e ----

def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in param.leaves(params))


def correlation(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.float().flatten().cpu().numpy(),
                             b.float().flatten().cpu().numpy())[0, 1])


def int8_phase(build, table, arrivals, frames, device, by_path) -> None:
    """Phase 5c: the registry's ``tangram_int8`` at full width (``tangram``
    quantized: the same seed, int8 trunk kernels, fp patch embed and
    head) against the fp build, then served on the trace unfused and fused
    like the fp detector (phases 4, 5, 5b)."""
    t0 = time.perf_counter()
    qbuild = make_model("tangram_int8").build(reduced=False, device=device)
    torch.cuda.synchronize()
    qcfg, qparams, qserve = qbuild
    if not qcfg.quant_weights:
        raise AssertionError("tangram_int8 built without quant_weights")
    # the head is not quantized, so the fp build's calibrated objectness
    # bias carries over as it is
    qparams["det_head"]["bias"].copy_(build[1]["det_head"]["bias"])
    registry = [make_model(n).weight_bytes / 1e6
                for n in ("tangram_int8", "tangram")]
    log(f"  built {qcfg.name} int8 in {time.perf_counter() - t0:.1f}s: "
        f"resident weights {weight_bytes(qparams) / 1e6:.2f} MB int8 vs "
        f"{weight_bytes(build[1]) / 1e6:.2f} MB {build[0].param_dtype}; "
        f"registry weight_bytes {registry[0]:.2f} / {registry[1]:.2f} MB")
    canvases = pack_canvases([a.patch for a in arrivals], frames, device)
    with torch.inference_mode():
        fp_raw = detector_lib.forward(build[0], build[1], canvases).float()
        q_raw = detector_lib.forward(qcfg, qparams, canvases).float()
    corr = correlation(torch.sigmoid(fp_raw[..., 0]),
                       torch.sigmoid(q_raw[..., 0]))
    log(f"  head objectness, fp vs int8 on the trace's {canvases.shape[0]} "
        f"canvases: correlation {corr:.5f} (bound > {INT8_OBJ_CORR}), raw "
        f"max abs diff {float((fp_raw - q_raw).abs().max()):.4f}")
    if not corr > INT8_OBJ_CORR:
        raise AssertionError(f"int8 head correlation {corr} <= "
                             f"{INT8_OBJ_CORR}")
    # the trunk's time, fp and int8, against each spec's modeled mu
    reps = -(-4 // canvases.shape[0])
    batch = canvases.repeat(reps, 1, 1, 1)[:4]
    for name, (cfg, params, _) in (("tangram", build),
                                   ("tangram_int8", qbuild)):
        kernel, bias = detector_lib.embed_params(cfg, params)
        tokens = layers.dense({"kernel": kernel, "bias": bias},
                              vit.patchify(batch, cfg.patch), kernel.dtype)
        model = make_model(name).latency_table(max_batch=4)
        trunk = detector_lib.tokens_fn(cfg)
        for b in (1, 4):
            ms = time_ms(lambda: trunk(params, tokens[:b]), iters=10)
            try:
                device_ms = graph_ms(lambda: trunk(params, tokens[:b]))
                device_ms = f"{device_ms:.3f} ms"
            except RuntimeError as err:     # a capture the trunk refuses
                device_ms = f"not measured ({err})"
            log(f"  {name} trunk, {b} canvas(es): {ms:.3f} ms a call (CUDA "
                f"events, back to back), device {device_ms} (CUDA graph); "
                f"modeled mu {model.mu_sigma(b)[0] * 1e3:.3f} ms")
    del canvases, batch, tokens, fp_raw, q_raw
    qtable = profile(qserve, qparams, CANVAS, CANVAS, device)
    log("  int8 latency table (measured): " + str(
        {k: (round(mu, 5), round(sd, 5))
         for k, (mu, sd) in qtable.table.items()}))
    for slo in (5.0, 0.5):
        trace = [dataclasses.replace(a, patch=dataclasses.replace(
            a.patch, slo=slo)) for a in arrivals]
        log(f"  int8, trace at SLO {slo}s:")
        for key, run in zip(("sync", "plain", "async"),
                            serve_phases(qbuild, qtable, trace, frames,
                                         device)):
            by_path[f"int8_unfused_{key}_slo{slo}"] = run["launches"]
            if key == "sync":
                unfused = run
        for key, run in fused_phases(qbuild, qtable, trace, frames, device,
                                     unfused).items():
            by_path[f"int8_fused_{key}_slo{slo}"] = run["launches"]


def scheduler_phase(build, table, arrivals, frames, device, by_path,
                    online: bool = False) -> float:
    """Phase 5d: ``TangramScheduler`` over a fused ``DeviceExecutor`` of the
    full-width detector, the trace at SLO 1.0; returns its violation rate.
    The platform carries only the meter, so the record's cost and platform
    invocations read 0, as in the JAX package.  ``online``: the invokers
    fire against an ``OnlineLatencyTable`` seeded with ``table``, which a
    one-worker pool around the executor feeds every completion (as the
    serve driver's ``--online-latency`` does)."""
    trace = [dataclasses.replace(a, patch=dataclasses.replace(a.patch,
                                                              slo=1.0))
             for a in arrivals]
    cfg, params, serve_fn = build
    ex = make_executor("device", serve_fn=serve_fn, params=params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       **fused_kwargs(cfg, params))
    executor = WorkerPoolExecutor([ex]) if online else ex
    source = trace_source(trace, frames)(executor)
    sched = TangramScheduler(
        CANVAS, CANVAS, table, Platform(table, PlatformConfig()),
        config=ServeConfig(max_canvases=4, executor="device", fuse=True,
                           online_latency=online),
        executor=executor)
    if online:
        executor.estimator = sched.estimator
    key = "scheduler_fused_online_slo1.0" if online else \
        "scheduler_fused_slo1.0"
    reset_launches()
    t0 = time.perf_counter()
    res = sched.serve_source(source, name="tangram_on_card")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path[key] = dict(LAUNCHES)
    check_launches({"launches": dict(LAUNCHES)}, FUSED, key)
    summary = res.summary()
    if online:
        log(f"  online table: {sched.estimator.n_observations} "
            f"observations, drift {sched.estimator.drift():.3f}x; "
            f"t_slack now " + ", ".join(
                f"{sched.estimator.t_slack(b) * 1e3:.1f} ms ({b})"
                for b in (1, 2, 4)))
    log(f"  TangramScheduler on the card ({wall:.2f}s wall, "
        f"{ex.n_invocations} device invocations, {ex.n_detections} "
        f"detections routed): Results.summary() = {json.dumps(summary)}")
    spans = sorted({(o.t_submit, o.t_finish) for o in res.outcomes})
    log("  invocations, measured wall (t_finish - t_submit) against the "
        "seed table's t_slack: " + ", ".join(
            f"{(f - s) * 1e3:.1f} ms vs {table.t_slack(b) * 1e3:.1f} ms "
            f"({b} canvases)" for (s, f), b in zip(spans, res.batch_sizes)))
    if summary["patches"] != len(trace) or len(ex.frames) != 0:
        raise AssertionError(f"scheduler: {summary['patches']} of "
                             f"{len(trace)} patches, {len(ex.frames)} frames "
                             f"held")
    if ex.n_invocations != len(res.batch_sizes) or res.invocations != 0:
        raise AssertionError("scheduler: invocations do not add up")
    if online and sched.estimator.n_observations != ex.n_invocations:
        raise AssertionError("scheduler: the online table missed "
                             "completions")
    return res.violation_rate


def sim_streams(device):
    """Per-camera patch streams of ``SIM_CAMERAS`` synthetic 2048x1024
    cameras (distinct scenes) through the edge pipeline on the card."""
    cams = make_source("synthetic", n_frames=SIM_FRAMES, canvas=CANVAS,
                       slo=1.0, n_cameras=SIM_CAMERAS, device=device)
    by_cam = {}
    for a in cams.events(None):
        by_cam.setdefault(a.patch.camera_id, []).append(a.patch)
    return [sorted(ps, key=lambda p: p.t_gen)
            for _, ps in sorted(by_cam.items())]


def simulation_phase(build, device):
    """Phase 5e: the paper's comparison (``benchmarks/fig12_e2e.py``'s
    grid: bandwidth x SLO; Tangram, Clipper, ELF, MArk, each on its own
    ``Platform(table, PlatformConfig())``) in simulation, on a latency
    table measured on the card over canvas batches of the full-width
    detector; returns that table."""
    cfg, params, serve_fn = build
    table = profile(serve_fn, params, CANVAS, CANVAS, device,
                    batch_sizes=(1, 2, 4, 8))
    log("  measured table for the simulation: " + str(
        {k: (round(v[0], 5), round(v[1], 5)) for k, v in table.table.items()}))
    t0 = time.perf_counter()
    base = sim_streams(device)
    n = sum(len(s) for s in base)
    log(f"  {SIM_CAMERAS} cameras x {SIM_FRAMES} frames of "
        f"{2 * CANVAS}x{CANVAS} -> {n} patches in "
        f"{time.perf_counter() - t0:.2f}s")
    area = CANVAS * CANVAS
    t0 = time.perf_counter()
    for bw in SIM_BWS:
        for slo in SIM_SLOS:
            streams = [[dataclasses.replace(p, slo=slo) for p in s]
                       for s in base]

            def plat():
                return Platform(table, PlatformConfig())

            arms = {
                "tangram": TangramScheduler(CANVAS, CANVAS, table,
                                            plat()).run(streams, bw),
                "clipper": baselines.run_clipper(streams, bw, plat(), area,
                                                 tile_side=CANVAS, slo=slo),
                "elf": baselines.run_elf(streams, bw, plat(), area),
                "mark": baselines.run_mark(streams, bw, plat(), area,
                                           tile_side=CANVAS,
                                           timeout=slo / 4),
            }
            for name, r in arms.items():
                if r.n_patches != n or not math.isfinite(r.total_cost):
                    raise AssertionError(f"sim {name}: {r.n_patches} of "
                                         f"{n} patches, cost {r.total_cost}")
                share = arms["tangram"].total_cost / r.total_cost
                saving = ("" if name == "tangram" else
                          f", Tangram saves {1 - share:.1%}")
                log(f"  sim {bw / 1e6:.0f} Mbps SLO {slo}s {name}: cost "
                    f"${r.total_cost:.6e}, violation rate "
                    f"{r.violation_rate:.4f}, {r.invocations} invocations"
                    + saving)
    log(f"  simulated {len(SIM_BWS) * len(SIM_SLOS)} cells x 4 arms in "
        f"{time.perf_counter() - t0:.2f}s")
    return table


# --------------------------------------------------------------- phase 5f ----

def model_trace(device):
    """The 2048x1024 cameras of phase 5f, one a class of ``MODEL_MAP``
    (scene i, camera i), made through K5 and merged by arrival as the
    serve driver's comma list of SLOs makes them (its ``build_source``)."""
    frames = {}
    args = argparse.Namespace(
        frames=MODEL_FRAMES, canvas=CANVAS, bandwidth_mbps=40.0,
        overload="drop", fps=10.0, source="trace", scene=0, cameras=1,
        frames_path=None)
    reset_launches()
    t0 = time.perf_counter()
    src = build_source(args, slos=[float(k) for k in MODEL_MAP],
                       device=device, frame_sink=lambda f, rgb, n:
                       frames.__setitem__(f, (rgb, n)))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"  edge: {len(MODEL_MAP)} cameras x {MODEL_FRAMES} frames of "
        f"{2 * CANVAS}x{CANVAS} -> {len(src.arrivals)} patches in "
        f"{time.perf_counter() - t0:.2f}s, launches {launches}")
    if launches["gmm_update"] != len(MODEL_MAP) * MODEL_FRAMES:
        raise AssertionError(f"phase 5f edge: K5 launched "
                             f"{launches['gmm_update']} times")
    return src.arrivals, frames, launches


def recording_runtime(build, heads: list, fuse: bool) -> ModelRuntime:
    """A model's runtime whose detector appends its head outputs to
    ``heads`` ((obj, boxes) unfused, the raw head fused)."""
    cfg, params, serve_fn = build

    def serve(p, canvases):
        obj, boxes = serve_fn(p, canvases)
        heads.append((obj, boxes))
        return obj, boxes

    fields = fused_fields(cfg, params) if fuse else {}
    if fuse:
        tokens_fn = fields["tokens_fn"]

        def tokens(p, t):
            raw = tokens_fn(p, t)
            heads.append((raw,))
            return raw

        fields["tokens_fn"] = tokens
    return ModelRuntime(serve, params, CANVAS, CANVAS, **fields)


def model_executor(name, impl, runtimes, fuse, device, record, mesh=None):
    """A device executor over the models' runtimes (tangram's the default
    one), on ``mesh`` when given (a worker's slice), instrumented: ``record["invs"]`` gets each invocation as it
    launches, ``record["by_model"]`` the launches it made, and
    ``record["outputs"]`` what each completion routed."""
    rt = runtimes["tangram"]
    fused = {}
    if fuse:
        fused = dict(fuse=True, tokens_fn=rt.tokens_fn,
                     embed_kernel=rt.embed_kernel, embed_bias=rt.embed_bias,
                     patch=rt.patch)
    ex = make_executor(name, serve_fn=rt.serve_fn, params=rt.params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       impl=impl, models=runtimes, max_inflight=4,
                       mesh=mesh, **fused)
    launch, release = ex._launch, ex.on_complete

    def counted(inv):
        before = dict(LAUNCHES)
        payload = launch(inv)
        row = record["by_model"].setdefault(inv.model,
                                            dict.fromkeys(LAUNCHES, 0))
        for k in LAUNCHES:
            row[k] += LAUNCHES[k] - before[k]
        record["invs"].append(inv)
        return payload

    def on_complete(comp):
        record["outputs"][id(comp.invocation)] = comp.outputs
        release(comp)

    ex._launch, ex.on_complete = counted, on_complete
    return ex


def model_result(record: dict, heads: list, builds: dict) -> dict:
    """A multi-model run in :func:`serve_run`'s shape, in launch order,
    with each invocation's detector patch."""
    routed, pixels = {}, {}
    invs = record["invs"]
    for inv in invs:
        per_frame, per_frame_pixels = record["outputs"][id(inv)]
        for fid, dets in per_frame.items():
            routed.setdefault(fid, []).extend(dets)
        for fid, px in per_frame_pixels.items():
            pixels.setdefault(fid, []).extend(px)
    return {"routed": routed, "pixels": pixels, "invocations": invs,
            "bounds": [[(p.frame_id, p.x0, p.y0) for p in inv.patches]
                       for inv in invs],
            "heads": [tuple(t.float().cpu().numpy() for t in h)
                      for h in heads],
            "patch": [builds[inv.model][0].patch for inv in invs],
            "by_model": record["by_model"], "launches": dict(LAUNCHES)}


def check_model_launches(run: dict, kernels: tuple, what: str) -> None:
    """Every model's invocations launched ``kernels`` and nothing else."""
    by_model = run["by_model"]
    if set(by_model) != set(MODEL_MAP.values()):
        raise AssertionError(f"{what}: models served {sorted(by_model)}")
    for model, row in by_model.items():
        if not all((row[k] > 0) == (k in kernels) for k in row):
            raise AssertionError(f"{what}: {model} launched {row}, "
                                 f"expected {kernels} only")
    log(f"  {what}: launches by model " + ", ".join(
        f"{m} {{{', '.join(f'{k}: {v}' for k, v in row.items() if v)}}}"
        for m, row in sorted(by_model.items())))


def models_serve(impl, builds, tables, arrivals, frames, device, fuse):
    """The three-class trace through one sync executor over the three
    models, each class's invoker on its model's profiled table."""
    heads, record = [], {"by_model": {}, "invs": [], "outputs": {}}
    runtimes = {n: recording_runtime(b, heads, fuse)
                for n, b in builds.items()}
    ex = model_executor("device", impl, runtimes, fuse, device, record)
    for fid, (rgb, n) in frames.items():
        ex.add_frame(fid, rgb, n)
    config = ServeConfig(max_canvases=4, executor="device", fuse=fuse,
                         classify="slo", model_map=MODEL_MAP)
    engine = ServingEngine(InvokerPool(
        lambda key: SLOAwareInvoker(CANVAS, CANVAS,
                                    tables[config.resolve_model(key)],
                                    config.max_canvases),
        classify=slo_class, model_of=config.resolve_model), ex)
    reset_launches()
    t0 = time.perf_counter()
    engine.run(arrivals)
    torch.cuda.synchronize()
    log(f"  [{'fused' if fuse else 'unfused'}, {impl or 'kernels'}] "
        + summary_line(engine, ex,
                       make_source("trace", arrivals=arrivals).stats(),
                       config, time.perf_counter() - t0))
    for line in detail_lines(engine, ex):
        log(f"  {line}")
    if len(ex.frames) != 0:
        raise AssertionError(f"phase 5f: {len(ex.frames)} frames held")
    return model_result(record, heads, builds)


def pool_serve(builds, tables, arrivals, frames, device, fuse):
    """``TangramScheduler`` over a two-worker model-placement pool of
    async executors (worker i on its serve mesh of ``make_worker_meshes``:
    one card, both on it), online latency tables seeded with the profiled ones, and weight
    caches sized to the largest model, as the serve driver sizes them."""
    config = ServeConfig(max_canvases=4, model_map=MODEL_MAP,
                         classify="slo", n_workers=2, placement="model",
                         online_latency=True, executor="async_device",
                         fuse=fuse)
    specs = {n: make_model(n) for n in config.model_names()}
    caches = weight_caches(
        config.n_workers, max(s.weight_bytes for s in specs.values()),
        {n: (s.weight_bytes, s.load_s) for n, s in specs.items()})
    heads, record = [], {"by_model": {}, "invs": [], "outputs": {}}
    runtimes = {n: recording_runtime(b, heads, fuse)
                for n, b in builds.items()}
    meshes = make_worker_meshes(config.n_workers)
    pool = device_worker_pool(
        config.n_workers,
        lambda i: model_executor("async_device", None, runtimes, fuse,
                                 data_devices(meshes[i])[0], record,
                                 mesh=meshes[i]),
        placement=make_placement(config.placement), weight_caches=caches)
    sched = TangramScheduler(CANVAS, CANVAS, tables["tangram"],
                             Platform(tables["tangram"], PlatformConfig()),
                             config=config, executor=pool)
    pool.estimator = sched.estimator
    source = trace_source(arrivals, frames)(pool)
    reset_launches()
    t0 = time.perf_counter()
    res = sched.serve_source(source, name="models_pool")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = res.summary()
    what = f"pool {'fused' if fuse else 'unfused'}"
    log(f"  [{what}] {summary['patches']} patches in "
        f"{pool.n_invocations} invocations ({wall:.2f}s wall), violation "
        f"rate {summary['violation_rate']}, {pool.n_detections} detections, "
        f"{len(pool.frames)} frames held")
    for model, row in summary["models"].items():
        log(f"    model {model}: {json.dumps(row)}")
    for row in summary["per_worker"]:
        log(f"    worker {row['worker']}: {row['invocations']} invocations, "
            f"{row['patches']} patches, busy {row['busy_s']}s, "
            f"utilization {row['utilization']}, drift {row['drift']}x, "
            f"weights {json.dumps(row['weights'])}")
    log("    invocations (model, canvases, patches): " + ", ".join(
        f"({inv.model}, {len(inv.canvases)}, {len(inv.patches)})"
        for inv in record["invs"]))
    if summary["patches"] != len(arrivals) or len(pool.frames) != 0:
        raise AssertionError(f"{what}: {summary['patches']} of "
                             f"{len(arrivals)} patches, {len(pool.frames)} "
                             f"frames held")
    if any(sched.estimator.table(m).n_observations == 0 for m in specs):
        raise AssertionError(f"{what}: the online tables learned nothing")
    run = model_result(record, heads, builds)
    run["summary"] = summary
    return run


def replay_plain(kern: dict, builds, frames, device, fuse) -> dict:
    """Every invocation of ``kern`` again, in launch order, through a sync
    executor on the plain versions: the same models and plans, so the
    outputs compare invocation for invocation whatever the run's timing
    made of its boundaries."""
    heads, record = [], {"by_model": {}, "invs": [], "outputs": {}}
    runtimes = {n: recording_runtime(b, heads, fuse)
                for n, b in builds.items()}
    ex = model_executor("device", "torch", runtimes, fuse, device, record)
    for fid, (rgb, n) in frames.items():
        ex.add_frame(fid, rgb, n)
    reset_launches()
    for inv in kern["invocations"]:
        ex.on_complete(ex.submit(inv).completion)
    if len(ex.frames) != 0:
        raise AssertionError(f"plain replay: {len(ex.frames)} frames held")
    return model_result(record, heads, builds)


def models_phase(build, device, by_path: dict) -> dict:
    """Phase 5f: ``vit_s16``, ``efficientnet_b7`` and ``tangram`` at full
    width on the three-class trace, routed by ``MODEL_MAP``: sync runs
    (kernels and plain, unfused and fused) on the profiled tables, then
    the two-worker model-placement pool with online tables, each of its
    invocations replayed through the plain versions."""
    builds = {"tangram": build}
    for name in MODEL_MAP.values():
        if name in builds:
            continue
        t0 = time.perf_counter()
        builds[name] = make_model(name).build(reduced=False, device=device)
        cfg = builds[name][0]
        log(f"  built {name}: canvas {cfg.canvas}, patch {cfg.patch}, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
            f"d_ff {cfg.d_ff}, {cfg.param_dtype} ({cfg.n_params / 1e6:.1f}M "
            f"params, {weight_bytes(builds[name][1]) / 1e6:.2f} MB; "
            f"registry weight_bytes "
            f"{make_model(name).weight_bytes / 1e6:.2f} MB) in "
            f"{time.perf_counter() - t0:.1f}s")
    arrivals, frames, edge = model_trace(device)
    by_path["models_edge"] = edge
    for name, b in builds.items():
        calibrate_head(b, arrivals, frames, device)
    tables = {}
    for name, (_, params, serve_fn) in builds.items():
        tables[name] = profile(serve_fn, params, CANVAS, CANVAS, device)
        log(f"  {name} latency table: " + str(
            {k: (round(v[0], 5), round(v[1], 5))
             for k, v in tables[name].table.items()}))
        # the registry spec carries the profiled table, so the pool's
        # scheduler seeds its online tables with what the card measured
        register_model(dataclasses.replace(make_model(name),
                                           table=tables[name]))
    runs, per_model = {}, {}
    for fuse, kernels in ((False, UNFUSED), (True, FUSED)):
        kind = "fused" if fuse else "unfused"
        kern = models_serve(None, builds, tables, arrivals, frames, device,
                            fuse)
        plain = models_serve("torch", builds, tables, arrivals, frames,
                             device, fuse)
        check_model_launches(kern, kernels, f"{kind} kernels")
        check_model_launches(plain, (), f"{kind} plain")
        if fuse:
            same_bounds_and_evidence(kern, runs["unfused"],
                                     "fused vs unfused")
            compare_fused(kern, plain, "fused kernels vs plain")
        else:
            same_result(kern, plain, "unfused kernels vs plain")
        runs[kind] = kern
        pool = pool_serve(builds, tables, arrivals, frames, device, fuse)
        check_model_launches(pool, kernels, f"pool {kind}")
        replay = replay_plain(pool, builds, frames, device, fuse)
        check_model_launches(replay, (), f"pool {kind} plain replay")
        if fuse:
            compare_fused(pool, replay, "pool fused kernels vs plain")
        else:
            same_result(pool, replay, "pool unfused kernels vs plain")
        for key, run in (("sync", kern), ("plain", plain), ("pool", pool),
                         ("pool_plain", replay)):
            by_path[f"models_{kind}_{key}"] = run["launches"]
            for model, row in run["by_model"].items():
                per_model.setdefault(model, {})[
                    f"models_{kind}_{key}"] = row
    return {"builds": builds, "frames": frames, "fused": runs["fused"],
            "by_model_path": per_model}


# --------------------------------------------------------------- phase 5g ----

def shard_trace(device):
    """Phase 5g's trace: ``SHARD_CAMERAS`` 2048x1024 cameras (scenes and
    camera ids 0-2) through K5, merged as the serve driver's ``--cameras``
    makes them (its ``build_source``)."""
    frames = {}
    args = argparse.Namespace(
        frames=SHARD_FRAMES, canvas=CANVAS, bandwidth_mbps=40.0,
        overload="drop", fps=10.0, source="trace", scene=0,
        cameras=SHARD_CAMERAS, frames_path=None)
    reset_launches()
    t0 = time.perf_counter()
    src = build_source(args, slos=[SHARD_SLO], device=device,
                       frame_sink=lambda f, rgb, n:
                       frames.__setitem__(f, (rgb, n)))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    cams = sorted({a.patch.camera_id for a in src.arrivals})
    log(f"  edge: {SHARD_CAMERAS} cameras x {SHARD_FRAMES} frames of "
        f"{2 * CANVAS}x{CANVAS} -> {len(src.arrivals)} patches from cameras "
        f"{cams} in {time.perf_counter() - t0:.2f}s, launches {launches}")
    if launches["gmm_update"] != SHARD_CAMERAS * SHARD_FRAMES:
        raise AssertionError(f"phase 5g edge: K5 launched "
                             f"{launches['gmm_update']} times")
    if {c % SHARDS for c in cams} != set(range(SHARDS)):
        raise AssertionError(f"phase 5g: cameras {cams} leave a shard idle")
    return src.arrivals, frames, launches


def new_record() -> dict:
    return {"invs": [], "outputs": {}, "heads": [], "streams": []}


def shard_runtime(build, rec: dict, fuse: bool, device) -> ModelRuntime:
    """:func:`recording_runtime` that also notes the stream current when
    the trunk is called (the shard's own, if the executor entered it)."""
    rt = recording_runtime(build, rec["heads"], fuse)

    def on_stream(fn):
        def run(p, x):
            rec["streams"].append(torch.cuda.current_stream(device))
            return fn(p, x)
        return run

    rt.serve_fn = on_stream(rt.serve_fn)
    if fuse:
        rt.tokens_fn = on_stream(rt.tokens_fn)
    return rt


def shard_executor(rt: ModelRuntime, impl, fuse, device, stream, rec,
                   mesh=None):
    """A sync executor over ``rt`` (on ``stream``, on ``mesh`` when given),
    instrumented:
    ``rec["invs"]`` gets each invocation as it launches, ``rec["outputs"]``
    what each completion routed."""
    fused = {}
    if fuse:
        fused = dict(fuse=True, tokens_fn=rt.tokens_fn,
                     embed_kernel=rt.embed_kernel, embed_bias=rt.embed_bias,
                     patch=rt.patch)
    ex = make_executor("device", serve_fn=rt.serve_fn, params=rt.params,
                       canvas_m=CANVAS, canvas_n=CANVAS, device=device,
                       impl=impl, stream=stream, mesh=mesh, **fused)
    launch, release = ex._launch, ex.on_complete

    def recorded(inv):
        rec["invs"].append(inv)
        return launch(inv)

    def on_complete(comp):
        rec["outputs"][id(comp.invocation)] = comp.outputs
        release(comp)

    ex._launch, ex.on_complete = recorded, on_complete
    return ex


def shard_result(rec: dict) -> dict:
    """One shard's run in :func:`serve_run`'s shape, in launch order."""
    routed, pixels = {}, {}
    for inv in rec["invs"]:
        per_frame, per_frame_pixels = rec["outputs"][id(inv)]
        for fid, dets in per_frame.items():
            routed.setdefault(fid, []).extend(dets)
        for fid, px in per_frame_pixels.items():
            pixels.setdefault(fid, []).extend(px)
    return {"routed": routed, "pixels": pixels, "invocations": rec["invs"],
            "bounds": [[(p.frame_id, p.x0, p.y0) for p in inv.patches]
                       for inv in rec["invs"]],
            "heads": [tuple(t.float().cpu().numpy() for t in h)
                      for h in rec["heads"]]}


def sharded_serve(build, table, arrivals, frames, device, fuse: bool,
                  parallel: bool) -> dict:
    """The trace through the serve driver's ``--shards 2`` objects
    (``--parallel`` with ``parallel``): one kernel executor a shard on
    its serve mesh of ``make_worker_meshes`` and its own stream from ``shard_stream``, one
    shared frame store, ``sharded_engine`` over fleet invoker pools on
    the profiled table, the virtual clock."""
    config = ServeConfig(max_canvases=4, executor="device", fuse=fuse,
                         shards=SHARDS, parallel=parallel)
    recs = [new_record() for _ in range(SHARDS)]
    streams, executors = [], []
    for s, mesh in enumerate(make_worker_meshes(SHARDS)):
        dev = data_devices(mesh)[0]
        if dev.type != device.type:
            raise AssertionError(f"shard {s} on {dev}, not on {device}")
        streams.append(shard_stream(dev))
        rt = shard_runtime(build, recs[s], fuse, dev)
        executors.append(shard_executor(rt, None, fuse, dev, streams[s],
                                        recs[s], mesh=mesh))
    share_frame_store(executors)
    for fid, (rgb, n) in frames.items():
        executors[0].add_frame(fid, rgb, n)
    source = make_source("trace", arrivals=arrivals)
    engine = sharded_engine(
        config, executors,
        lambda fleet: fleet_uniform_pool(CANVAS, CANVAS, table,
                                         max_canvases=config.max_canvases),
        source, table)
    torch.cuda.synchronize()       # the weights, written on another stream
    reset_launches()
    t0 = time.perf_counter()
    engine.serve(source)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    what = (f"shards {'fused' if fuse else 'unfused'} "
            f"{'parallel' if parallel else 'sequential'}")
    log(f"  [{what}] " + summary_line(engine, executors, source.stats(),
                                      config, wall))
    for line in shard_lines(engine):
        log(line)
    # each sync invocation's measured wall, summed over both shards: above
    # the run's wall only where the shards' invocations overlapped
    busy = sum(c.t_finish - c.invocation.t_submit for c in engine.completions)
    log(f"    invocation walls sum to {busy:.3f} s in a {wall:.3f} s run "
        f"({busy / wall:.2f}x)")
    n_inv = len(engine.invocations)
    kernels = FUSED if fuse else UNFUSED
    if any(launches[k] != (n_inv if k in kernels else 0) for k in launches):
        raise AssertionError(f"{what}: launches {launches} for {n_inv} "
                             f"invocations, expected {kernels} once each")
    if len(engine.outcomes) != len(arrivals) or len(executors[0].frames):
        raise AssertionError(f"{what}: {len(engine.outcomes)} of "
                             f"{len(arrivals)} patches, "
                             f"{len(executors[0].frames)} frames held")
    for s, (rec, stream) in enumerate(zip(recs, streams)):
        if not rec["streams"] or any(x != stream for x in rec["streams"]):
            raise AssertionError(f"{what}: shard {s}'s trunk ran on "
                                 f"{set(rec['streams'])}, not its stream "
                                 f"{stream}")
        log(f"    shard {s}: stream id {stream.stream_id} "
            f"(0x{stream.cuda_stream:x}) on {stream.device} carried "
            f"{len(rec['streams'])} invocations, "
            f"{sum(len(i.patches) for i in rec['invs'])} patches")
    if streams[0] == streams[1]:
        raise AssertionError(f"{what}: the shards share a stream")
    return {"shards": [shard_result(r) for r in recs], "wall": wall,
            "launches": launches, "engine": engine,
            "rows": engine.shard_stats()}


def shard_replay(kern: dict, build, frames, device, fuse: bool) -> list:
    """Every invocation of each shard of ``kern`` again, in launch order,
    through one sync executor on the plain versions (the current
    stream)."""
    recs = [new_record() for _ in kern["shards"]]
    executors = [shard_executor(recording_runtime(build, rec["heads"], fuse),
                                "torch", fuse, device, None, rec)
                 for rec in recs]
    share_frame_store(executors)
    for fid, (rgb, n) in frames.items():
        executors[0].add_frame(fid, rgb, n)
    reset_launches()
    for ex, shard in zip(executors, kern["shards"]):
        for inv in shard["invocations"]:
            ex.on_complete(ex.submit(inv).completion)
    if len(executors[0].frames) != 0:
        raise AssertionError(f"plain replay: {len(executors[0].frames)} "
                             f"frames held")
    if any(LAUNCHES.values()):
        raise AssertionError(f"plain replay launched {dict(LAUNCHES)}")
    return [shard_result(rec) for rec in recs]


def heads_diff(a: dict, b: dict) -> float:
    return max((float(np.abs(x - y).max()) for ha, hb in
                zip(a["heads"], b["heads"]) for x, y in zip(ha, hb)),
               default=0.0)


def same_shard_runs(seq: dict, par: dict, fuse: bool) -> None:
    """Sequential against parallel, shard by shard: equal boundaries and
    evidence, and head outputs bit-equal with equal detections; where the
    heads are not bit-equal, the largest difference is printed and the
    fused runs are held to phase 5b's limits."""
    for s, (a, b) in enumerate(zip(seq["shards"], par["shards"])):
        what = f"shard {s} {'fused' if fuse else 'unfused'} parallel vs " \
               f"sequential"
        same_bounds_and_evidence(a, b, what)
        if len(a["heads"]) == len(b["heads"]) and heads_diff(a, b) == 0.0:
            same_result(a, b, what)
            continue
        log(f"  {what}: head outputs differ by up to {heads_diff(a, b):.4g}")
        if not fuse:
            raise AssertionError(f"{what}: unfused heads differ")
        compare_fused(a, b, what)


def covers_unsharded(run: dict, unsharded: dict, what: str) -> None:
    """The shards' outcomes together cover exactly the unsharded run's
    patches."""
    got = collections.Counter(
        (o.patch.frame_id, o.patch.x0, o.patch.y0, o.patch.x1, o.patch.y1)
        for o in run["engine"].outcomes)
    want = collections.Counter(
        (p.frame_id, p.x0, p.y0, p.x1, p.y1)
        for inv in unsharded["invocations"] for p in inv.patches)
    if got != want:
        raise AssertionError(f"{what}: the shards served {sum(got.values())} "
                             f"patches, the unsharded run "
                             f"{sum(want.values())}, not the same ones")


def fleet_simulation(table, card: str) -> None:
    """``TangramScheduler`` with ``shards=FLEET_SHARDS`` and the cost
    planner over ``FLEET_CAMERAS`` simulated cameras, sequential and
    ``parallel=True``, on a table profiled on the card: equal summaries,
    per-shard rows included.  The host's arrival rate is a reading."""
    summaries = {}
    for parallel in (False, True):
        src = FleetCameraSource(n_cameras=FLEET_CAMERAS,
                                duration_s=FLEET_SECONDS, seed=0)
        sched = TangramScheduler(
            CANVAS, CANVAS, table, Platform(table, PlatformConfig()),
            config=ServeConfig(shards=FLEET_SHARDS, planner="cost",
                               parallel=parallel))
        t0 = time.perf_counter()
        res = sched.serve_source(src, name="fleet")
        wall = time.perf_counter() - t0
        summary = summaries[parallel] = res.summary()
        log(f"  fleet {'parallel' if parallel else 'sequential'}: "
            f"{FLEET_CAMERAS} cameras x {FLEET_SECONDS:.0f} s, "
            f"{res.n_patches} arrivals in {wall:.3f} s of host time "
            f"({res.n_patches / wall:.1f} arrivals/s), violation rate "
            f"{summary['violation_rate']}, cost ${summary['cost_usd']}, "
            f"{summary['invocations']} invocations ({card})")
        for row in summary["per_shard"]:
            log(f"    shard {row['shard']}: {row['cameras']} cameras, "
                f"{row['arrivals']} arrivals, {row['invocations']} "
                f"invocations, {row['violations']} violations, utilization "
                f"{row.get('utilization')}")
        if res.n_patches != src.stats().arrivals or res.n_patches == 0:
            raise AssertionError(f"fleet: {res.n_patches} of "
                                 f"{src.stats().arrivals} arrivals served")
    if summaries[True] != summaries[False]:
        raise AssertionError("fleet: parallel and sequential summaries "
                             "differ")
    log("  fleet: parallel and sequential Results.summary() equal, "
        "per-shard rows included")


def shards_phase(build, table, sim_table, device, by_path: dict,
                 card: str) -> None:
    """Phase 5g: the three-camera trace through two shards, unfused and
    fused, sequential and parallel, each shard on its own stream, against
    each other, the plain versions and the unsharded run; then the
    simulated fleet."""
    arrivals, frames, edge = shard_trace(device)
    by_path["shards_edge"] = edge
    unsharded = serve_run("device", None, build, table,
                          trace_source(arrivals, frames), device)
    check_launches(unsharded, UNFUSED, "unsharded")
    by_path["shards_unsharded"] = unsharded["launches"]
    for fuse in (False, True):
        kind = "fused" if fuse else "unfused"
        runs = {}
        for parallel in (False, True):
            run = sharded_serve(build, table, arrivals, frames, device, fuse,
                                parallel)
            key = "parallel" if parallel else "sequential"
            by_path[f"shards_{kind}_{key}"] = run["launches"]
            covers_unsharded(run, unsharded, f"shards {kind} {key}")
            runs[key] = run
        seq, par = runs["sequential"], runs["parallel"]
        for s, (a, b) in enumerate(zip(seq["shards"], par["shards"])):
            if not a["bounds"]:
                raise AssertionError(f"shard {s} {kind}: no invocations")
        same_shard_runs(seq, par, fuse)
        plain = shard_replay(seq, build, frames, device, fuse)
        by_path[f"shards_{kind}_plain"] = dict(LAUNCHES)
        for s, (a, b) in enumerate(zip(seq["shards"], plain)):
            what = f"shard {s} {kind} kernels vs plain"
            if fuse:
                compare_fused(a, b, what)
            else:
                same_result(a, b, what)
        log(f"  shards {kind}: wall {seq['wall']:.3f} s sequential, "
            f"{par['wall']:.3f} s parallel ({card})")
        del runs, seq, par, plain
    fleet_simulation(sim_table, card)


# ---------------------------------------------------------------- phase 6 ----

def main_path_plan(run: dict, frames: dict, device):
    """The main path's largest invocation, re-packed from its frames."""
    inv = max(run["invocations"],
              key=lambda i: (len(i.canvases), len(i.patches)))
    plan = inv.batch_plan()
    crops = [frames[p.frame_id][0][p.y0:p.y1, p.x0:p.x1]
             for p in inv.patches]
    t0 = time.perf_counter()
    host = stitch_ops.pack_plan_host(crops, plan)
    t1 = time.perf_counter()
    slots = torch.from_numpy(host).to(device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  host staging at the largest invocation ({len(inv.patches)} "
        f"patches, {plan.num_canvases} canvases): pack "
        f"{(t1 - t0) * 1e3:.2f} ms, host->device {(t2 - t1) * 1e3:.2f} ms "
        f"for {host.nbytes / 1e6:.1f} MB")
    records = torch.from_numpy(plan.records).to(device)
    return plan, slots, records


def time_invocation(plan, slots, records, build) -> None:
    """Device time of each stage of one unfused invocation (CUDA events)."""
    cfg, params, serve_fn = build
    canvases = stitch_ops.stitch_canvases(slots, records, CANVAS, CANVAS)
    before = dict(LAUNCHES)
    det_ms = time_ms(lambda: serve_fn(params, canvases), iters=10)
    patch_out = stitch_ops.unstitch_patches(
        canvases, records, plan.slot_capacity, plan.hmax, plan.wmax)
    LAUNCHES.update(before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = patch_out.cpu().numpy()
    d2h = (time.perf_counter() - t0) * 1e3
    log(f"  unfused: detector ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.compute_dtype}) on {plan.num_canvases} canvases: "
        f"{det_ms:.3f} ms; evidence device->host {d2h:.2f} ms for "
        f"{host.nbytes / 1e6:.1f} MB")


def fused_rows(plan, slots, records, build, launches, worst,
               model=None) -> list:
    """Time K4/K3 on one plan with the model's own weights and head, and
    the fused invocation's device stages.  K4's bound: 2*B*seq*K*d
    operations at the bf16 peak, or the bytes it must move (records,
    placed f32 pixels, weights, bias, tokens written), whichever is
    larger; K3's: the bytes (records, raw head, grids written) or about
    30 float32 operations per cell at the CUDA cores' peak.  With
    ``model`` the rows are that registry model's (named ``kernel[model]``)
    and ``worst`` is None: the error is this plan's, kernel vs plain."""
    cfg, params, _ = build
    patch = cfg.patch
    tokens_fn = detector_lib.tokens_fn(cfg)
    kernel, bias = detector_lib.embed_params(cfg, params)
    m = n = CANVAS
    b, cap = plan.num_canvases, plan.slot_capacity
    seq = (m // patch) * (n // patch)
    k_dim, d = kernel.shape
    before = dict(LAUNCHES)
    tokens = stitch_ops.stitch_embed(slots, records, kernel, bias, m, n,
                                     patch)
    raw = tokens_fn(params, tokens)
    if worst is None:
        # phase 3b's tolerances: bf16 K4 within 2e-2, K3 within 1e-5 with
        # equal hit masks
        plain_tokens = stitch_ops.stitch_embed(slots, records, kernel, bias,
                                               m, n, patch, impl="torch")
        torch.testing.assert_close(tokens.float(), plain_tokens.float(),
                                   atol=2e-2, rtol=2e-2)
        got = stitch_ops.unstitch_decode(raw, records, patch, cap)
        want = stitch_ops.unstitch_decode(raw, records, patch, cap,
                                          impl="torch")
        if not torch.equal(got[..., 0] > 0, want[..., 0] > 0):
            raise AssertionError(f"{model}: K3 hit masks differ")
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        worst = {"stitch_embed_bfloat16": max_abs_err(tokens, plain_tokens),
                 "stitch_embed_float32": None,
                 "unstitch_decode": max_abs_err(got, want)}
    # the library yardstick for K4: one cuBLAS GEMM plus bias on the canvas
    # batch already stitched and patchified in bf16 (the port never calls it)
    x = vit.patchify(stitch_ops.stitch_canvases(slots, records, m, n),
                     patch).to(kernel.dtype).contiguous()
    k4_plain = time_ms(lambda: stitch_ops.stitch_embed(
        slots, records, kernel, bias, m, n, patch, impl="torch"), iters=10)
    k4 = timed(lambda: stitch_ops.stitch_embed(
        slots, records, kernel, bias, m, n, patch, impl="cuda"))
    k4_lib = timed(lambda: torch.matmul(x, kernel) + bias)
    trunk_ms = time_ms(lambda: tokens_fn(params, tokens), iters=10)
    k3_plain = time_ms(lambda: stitch_ops.unstitch_decode(
        raw, records, patch, cap, impl="torch"), iters=10)
    k3 = timed(lambda: stitch_ops.unstitch_decode(
        raw, records, patch, cap, impl="cuda"))
    # what one launch costs the card: a trivial PyTorch kernel in the same
    # graph harness, the floor K3's device time reads against
    one = torch.zeros(1, device=raw.device)
    launch_floor = graph_ms(lambda: one.fill_(1.0))
    k4_ms, k3_ms = k4["ms_call"], k3["ms_call"]
    grids = stitch_ops.unstitch_decode(raw, records, patch, cap)
    LAUNCHES.update(before)      # timing launches not counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = grids.cpu().numpy()
    d2h = (time.perf_counter() - t0) * 1e3

    rec_bytes = records.numel() * 4
    k4_ops = 2 * b * seq * k_dim * d
    k4_bytes = (rec_bytes + placed_elements(plan) * 4
                + kernel.numel() * kernel.element_size()
                + bias.numel() * bias.element_size()
                + tokens.numel() * tokens.element_size())
    k4_times = (k4_ops / H100.peak_flops, k4_bytes / H100.hbm_bw)
    cells = raw.shape[1] * raw.shape[2]
    k3_ops = 30 * b * cells
    k3_bytes = (rec_bytes + raw.numel() * raw.element_size()
                + grids.numel() * 4)
    k3_times = (k3_ops / F32_PEAK, k3_bytes / H100.hbm_bw)
    source = "src/repro_torch/kernels/stitch/csrc/fused_embed.cu"
    rows = [
        {"name": "stitch_embed", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/stitch/fused_embed.py:114",
         "launches": launches["stitch_embed"],
         "max_abs_err": worst["stitch_embed_bfloat16"],
         "max_abs_err_f32_weights": worst["stitch_embed_float32"],
         "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": max(k4_times) * 1e3,
         "bound_by": "operations" if k4_times[0] >= k4_times[1]
         else "bytes",
         "library_ms": k4_lib["ms_call"],
         "library_ms_device": k4_lib["ms_device"],
         "library_call": "torch.matmul(x, kernel) + bias: the cuBLAS GEMM "
                         "alone, on the stitched, patchified bf16 canvas "
                         "batch", **device_keys(k4)},
        {"name": "unstitch_decode", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/stitch/fused_embed.py:202",
         "launches": launches["unstitch_decode"],
         "max_abs_err": worst["unstitch_decode"],
         "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": max(k3_times) * 1e3,
         "bound_by": "operations" if k3_times[0] >= k3_times[1]
         else "bytes",
         "library_ms": None, "launch_floor_ms": launch_floor,
         "redesigned": "slot-major, one launch, no memset",
         **device_keys(k3)}]
    if model is not None:
        shape = (f"B={b} canvases of {m}^2, patch {patch}, K={k_dim}, "
                 f"d={d}, {seq} tokens and a {m // patch}x{n // patch} head "
                 f"grid a canvas, {plan.slots_per_canvas} records a canvas, "
                 f"{cap} slots")
        for row in rows:
            row.update(name=f"{row['name']}[{model}]", kernel=row["name"],
                       model=model, shape=shape)
        log(f"  {model}: {shape}")
    log(f"  stitch_embed: {fmt_times(k4)} (plain {k4_plain:.4f} ms, cuBLAS "
        f"GEMM + bias {fmt_times(k4_lib)}, bound "
        f"{rows[0]['bound_ms']:.4f} ms for {k4_ops / 1e9:.2f} GFLOP / "
        f"{k4_bytes / 1e6:.2f} MB)")
    log(f"  unstitch_decode: {fmt_times(k3)} (plain {k3_plain:.4f} ms, "
        f"bound {rows[1]['bound_ms']:.5f} ms for {k3_bytes / 1e6:.2f} MB, "
        f"launch floor {launch_floor:.4f} ms device)")
    log(f"  fused: K4 {k4['ms_device']:.4f} ms (device); trunk from tokens "
        f"({cfg.n_layers} layers) {trunk_ms:.3f} ms; K3 "
        f"{k3['ms_device']:.4f} ms (device); grids "
        f"device->host {d2h:.2f} ms for {host.nbytes / 1e6:.2f} MB")
    return rows


# --------------------------------------------------------------- phase 4c ----

def record_4k(frames, directory) -> pathlib.Path:
    """The 4K scene's frames as an 8-bit (T, H, W) recording, so the file
    source takes its 8-bit path."""
    path = pathlib.Path(directory) / "camera4k.npy"
    stack = np.round(np.stack(frames) * 255).astype(np.uint8)
    np.save(path, stack)
    log(f"  recording: {stack.shape[0]} frames of {CAM_W}x{CAM_H} uint8, "
        f"{stack.nbytes / 1e6:.1f} MB")
    return path


def file_source(path, device, gmm_impl, shipped: dict):
    """``source_fn`` for :func:`serve_run`: the recording streamed live
    through ``make_source("file")``, frames registered as they are cut
    and kept in ``shipped``."""
    def make(ex):
        def sink(frame_id, rgb, n_patches):
            ex.add_frame(frame_id, rgb, n_patches)
            shipped[frame_id] = (rgb, n_patches)
        return make_source("file", path=path, canvas=CANVAS, slo=5.0,
                           frame_sink=sink, device=device, gmm_impl=gmm_impl)
    return make


def file_phase(build, table, path, device):
    """The 4K recording served on the fused path, kernels (K5, K4, K3)
    against plain versions.  Returns the runs and the frames shipped."""
    runs, shipped = {}, {}
    for key, impl in (("kernels", None), ("plain", "torch")):
        runs[key] = serve_run("device", impl, build, table,
                              file_source(path, device, impl, shipped),
                              device, fuse=True)
    kern, plain = runs["kernels"], runs["plain"]
    check_launches(kern, FUSED + GMM, "4K file kernels")
    check_launches(plain, (), "4K file plain")
    if kern["launches"]["gmm_update"] != EDGE_FRAMES:
        raise AssertionError(f"4K file: K5 launched "
                             f"{kern['launches']['gmm_update']} times for "
                             f"{EDGE_FRAMES} frames")
    if not kern["arrivals"]:
        raise AssertionError("4K file: no arrivals")
    same_arrivals(kern["arrivals"], plain["arrivals"], "4K file")
    same_bounds_and_evidence(kern, plain, "4K file kernels vs plain")
    if not margin_filter(kern["routed"]):
        raise AssertionError("4K file: no detections routed")
    log(f"  4K file: {len(kern['arrivals'])} arrivals equal, "
        f"{len(kern['bounds'])} invocations")
    compare_fused(kern, plain, "4K file fused kernels vs plain")
    return runs, shipped


def edge_split(path, device) -> dict:
    """Seconds per stage of each 4K frame: the file source's load, the
    frame's host->device copy, the GMM update (K5, then the plain
    version), the frame's RGB copy for the frame store, RoI extraction,
    partitioning, and packing the frame's patches into slots and copying
    them to the card.  The stages run one at a time, as the edge pipeline
    calls them, with a sync after each; stages the pipeline skips during
    warm-up are skipped too.  Returns the medians over frames past
    warm-up."""
    t0 = time.perf_counter()
    recording = load_frames(path)
    load_s = (time.perf_counter() - t0) / len(recording)
    roi_cfg = RoIConfig()
    medians = {}
    for impl in ("cuda", "torch"):
        state = gmm_core.init_state(CAM_H, CAM_W, device=device)
        rows, t_gen = [], 0.0
        for idx, frame in enumerate(recording):
            t_gen += 1.0 / 10.0          # the rate clock's default 10 fps
            s = {"load": load_s}
            t = time.perf_counter()

            def lap(name):
                nonlocal t
                now = time.perf_counter()
                s[name] = now - t
                t = now

            x = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
            torch.cuda.synchronize()
            lap("h2d")
            state, fg = gmm_ops.gmm_update(state, x, impl=impl)
            torch.cuda.synchronize()
            lap("gmm")
            rgb = np.stack([frame, frame, frame], axis=-1)
            lap("rgb")
            if t_gen >= 1.0:
                boxes, valid = extract_rois(fg, roi_cfg)
                boxes_np = boxes[valid].cpu().numpy()
                lap("rois")
                patches = partitioning.partition_host(
                    boxes_np, CAM_W, CAM_H, 4, 4, frame_id=idx,
                    camera_id=0, t_gen=t_gen, slo=5.0)
                patches = [dataclasses.replace(
                    p, x1=min(p.x1, p.x0 + CANVAS),
                    y1=min(p.y1, p.y0 + CANVAS)) for p in patches]
                lap("partition")
                s["patches"] = len(patches)
                if patches:
                    plan = build_batch_plan(
                        patches, stitch(patches, CANVAS, CANVAS), CANVAS,
                        CANVAS)
                    host = stitch_ops.pack_plan_host(
                        [rgb[p.y0:p.y1, p.x0:p.x1] for p in patches], plan)
                    lap("pack")
                    torch.from_numpy(host).to(device)
                    torch.cuda.synchronize()
                    lap("slots_h2d")
                    s["slot_mb"] = host.nbytes / 1e6
                rows.append(s)
            log(f"  [{impl}] frame {idx:2d}: " + ", ".join(
                f"{k} {v:.1f}" if k == "slot_mb" else
                f"{k} {v:.6f}s" if isinstance(v, float) else f"{k} {v}"
                for k, v in s.items()))
        medians[impl] = {k: statistics.median(r.get(k, 0.0) for r in rows)
                         for k in ("load", "h2d", "gmm", "rgb", "rois",
                                   "partition", "pack", "slots_h2d")}
        total = sum(medians[impl].values())
        log(f"  [{impl}] median 4K frame past warm-up: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms ({v / total:.1%})"
            for k, v in medians[impl].items()) + f"; sum {total * 1e3:.2f} ms")
    return medians


def serve_cli(path) -> str:
    """The serve driver on the recording, once, as a user runs it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--source",
           "file", "--frames-path", str(path), "--frames", str(EDGE_FRAMES),
           "--canvas", str(CANVAS), "--fuse"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve driver failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    summary = next(line for line in lines if line.startswith("served "))
    log(f"  serve driver ({time.perf_counter() - t0:.1f}s): "
        f"{' '.join(cmd[1:])}")
    for line in lines:
        if line.startswith(("served ", "source ")):
            log(f"    {line}")
    if ", fused" not in summary or "(0 frames still held" not in summary:
        raise AssertionError(f"serve driver: unexpected summary {summary}")
    return summary


def gmm_row(state_4k, device, launches: int, worst: dict) -> dict:
    """K5's row: time at 3840x2160 (the 4K scene's state after its
    frames, a random frame) and at 2048x1024 (a random state); bound = 77
    bytes a pixel at the HBM rate, or ~100 float32 operations a pixel at
    the CUDA cores' peak, whichever is larger."""
    rng = np.random.default_rng(9)
    times = {}
    for h, w in ((CAM_H, CAM_W), (CANVAS, 2 * CANVAS)):
        if h == CAM_H:
            state = state_4k
            x = torch.from_numpy(rng.random((h, w), np.float32)).to(device)
        else:
            state, x = gmm_case("random", h, w, rng, device)
        before = dict(LAUNCHES)
        plain = time_ms(lambda: gmm_ops.gmm_update(state, x, impl="torch"),
                        iters=10)
        t = timed(lambda: gmm_ops.gmm_update(state, x, impl="cuda"))
        LAUNCHES.update(before)         # timing launches not counted
        pixels = h * w
        bound = (pixels * GMM_OPS_PER_PIXEL / F32_PEAK,
                 pixels * GMM_BYTES_PER_PIXEL / H100.hbm_bw)
        times[(h, w)] = (t, plain, max(bound) * 1e3,
                         "operations" if bound[0] >= bound[1] else "bytes")
        log(f"  gmm_update {w}x{h}: {fmt_times(t)} (plain {plain:.4f} ms, "
            f"bound {max(bound) * 1e3:.4f} ms for "
            f"{pixels * GMM_BYTES_PER_PIXEL / 1e6:.1f} MB, "
            f"{max(bound) * 1e3 / t['ms_device']:.1%} of the bound's speed "
            f"on the device)")
    t, plain, bound_ms, bound_by = times[(CAM_H, CAM_W)]
    t2, plain2, bound2, _ = times[(CANVAS, 2 * CANVAS)]
    return {"name": "gmm_update", "route": "cuda",
            "source": "src/repro_torch/kernels/gmm/csrc/gmm.cu",
            "replaces": "src/repro/kernels/gmm/gmm.py:72",
            "launches": launches,
            "launches_counted": "phase 4c: the 4K recording served with "
                                "kernels, one launch per frame",
            "max_abs_err": worst["max_abs_err"],
            "mask_pixels_differing": worst["mask_pixels"],
            "shape": [CAM_H, CAM_W], "ms": t["ms_call"], "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "update", **device_keys(t),
            "ms_2048x1024": t2["ms_call"], "plain_ms_2048x1024": plain2,
            "bound_ms_2048x1024": bound2,
            **device_keys(t2, "_2048x1024")}


# --------------------------------------------------------------- phase 7 ----

def attn_inputs(rng, shapes, dtype, device):
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        device, dtype) for sh in shapes]


def packed_segment_ids(rng, rows: int, seq: int) -> np.ndarray:
    """Requests of random length packed into ``seq``-token rows by the
    port's sequence packer; the first ``rows`` rows' segment ids (each
    row's unused tail is a segment of its own)."""
    lengths = [int(n) for n in rng.integers(16, seq // 2, size=8 * rows)]
    packed = sequence_packing.pack(
        [sequence_packing.Request(n, 0.0, 1.0, i)
         for i, n in enumerate(lengths)], seq)
    if len(packed) < rows:
        raise AssertionError(f"packing gave {len(packed)} rows, need {rows}")
    log(f"  packed {len(lengths)} requests into {len(packed)} rows of "
        f"{seq} tokens (efficiency "
        f"{sequence_packing.packing_efficiency(packed):.3f}); rows 0-"
        f"{rows - 1}: {[len(r.spans) for r in packed[:rows]]} requests")
    return sequence_packing.segment_ids(packed[:rows])


def attention_cases():
    """(name, kind, shapes and options) of phase 7; K6 on minitron-4b's
    per-layer shape, packed rows, the ViT-B/16 encoder's 197 tokens, a
    ragged causal length, float32 and deepseek-moe-16b's layer (G = 1); K7
    on the decode cache, deepseek-moe-16b's (G = 1, D 128), a one-card
    decode_32k slice and a position far below its cache, each at the host
    int and at a device pos."""
    h, kvh, d = 24, 8, 128
    cases = [("K6 causal", "k6", dict(b=2, s=LM_SEQ, h=h, kvh=kvh, d=d,
                                      causal=True)),
             ("K6 packed rows", "k6", dict(b=2, s=LM_SEQ, h=h, kvh=kvh, d=d,
                                           causal=True, packed=True)),
             ("K6 ViT-B/16", "k6", dict(b=4, s=197, h=12, kvh=12, d=64,
                                        causal=False)),
             ("K6 causal ragged", "k6", dict(b=1, s=LM_SEQ - 1, h=h, kvh=kvh,
                                             d=d, causal=True)),
             ("K6 float32", "k6", dict(b=2, s=300, h=6, kvh=2, d=64,
                                       causal=True, dtype=torch.float32)),
             # deepseek-moe-16b's prefill layer: 16 heads over 16, G = 1
             ("K6 G=1 D=128", "k6", dict(b=2, s=LM_SEQ, h=16, kvh=16, d=d,
                                         causal=True))]
    # K7 at the chunk and block-pass edges of minitron's cache (1 chunk a
    # pair up to pos 63, 8 from pos 511), G 1 / 3 / 8 / 24 and D 32 / 64 /
    # 128, float32, more pairs than SMs (one chunk), the 32k slice
    for pos in (0, 63, 64, 511, 512, LM_SEQ - 1):
        cases.append((f"K7 pos {pos}", "k7", dict(b=2, smax=LM_SEQ, h=h,
                                                  kvh=kvh, d=d, pos=pos)))
    cases += [
        ("K7 G=1 D=32", "k7", dict(b=2, smax=2048, h=8, kvh=8, d=32,
                                   pos=1999)),
        # deepseek-moe-16b's decode cache: 16 heads over 16, G = 1
        ("K7 G=1 D=128 pos 79", "k7", dict(b=2, smax=LM_SEQ, h=16, kvh=16,
                                           d=d, pos=79)),
        ("K7 G=1 D=128", "k7", dict(b=2, smax=LM_SEQ, h=16, kvh=16, d=d,
                                    pos=LM_SEQ - 1)),
        ("K7 G=8 D=64", "k7", dict(b=3, smax=2048, h=64, kvh=8, d=64,
                                   pos=1500)),
        ("K7 G=24 D=128", "k7", dict(b=1, smax=LM_SEQ, h=48, kvh=2, d=d,
                                     pos=3000)),
        ("K7 B=64 one chunk", "k7", dict(b=64, smax=512, h=h, kvh=kvh, d=d,
                                         pos=511)),
        ("K7 float32", "k7", dict(b=2, smax=1024, h=6, kvh=2, d=64, pos=700,
                                  dtype=torch.float32)),
        ("K7 decode_32k slice", "k7", dict(b=8, smax=8 * LM_SEQ, h=h,
                                           kvh=kvh, d=d,
                                           pos=8 * LM_SEQ - 1)),
        # far below Smax: one live chunk, seven empty blocks a cluster
        (f"K7 pos 5 of {8 * LM_SEQ}", "k7", dict(b=2, smax=8 * LM_SEQ, h=h,
                                                 kvh=kvh, d=d, pos=5))]
    return cases


def attn_close(got, want, kind: str, dtype):
    """(ok, max abs err, row-scaled err) of a ``kind`` ("k6" or "k7")
    output: within ATTN_TOL elementwise and every row within ATTN_ROW_TOL
    of its own scale."""
    err, scaled = max_abs_err(got, want), row_scaled_err(got, want)
    tol = ATTN_TOL[dtype]
    ok = (got.shape == want.shape and got.dtype == dtype
          and bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
          and scaled <= ATTN_ROW_TOL[kind, dtype])
    return ok, err, scaled


def check_attention(device) -> dict:
    """Phase 7: K6 and K7 against their plain versions; the largest abs
    and row-scaled errors per kernel and dtype."""
    rng = np.random.default_rng(7)
    worst = {}
    for name, kind, c in attention_cases():
        dtype = c.get("dtype", torch.bfloat16)
        if kind == "k6":
            b, s = c["b"], c["s"]
            q, k, v = attn_inputs(rng, [(b, s, c["h"], c["d"]),
                                        (b, s, c["kvh"], c["d"]),
                                        (b, s, c["kvh"], c["d"])], dtype,
                                  device)
            seg = None
            if c.get("packed"):
                seg = torch.from_numpy(packed_segment_ids(rng, b, s)).to(
                    device)
            got = attn_ops.flash_attention(q, k, v, causal=c["causal"],
                                           segment_ids=seg, impl="cuda")
            want = attn_ops.flash_attention(q, k, v, causal=c["causal"],
                                            segment_ids=seg, impl="torch")
            shape = f"B={b} S={s} H={c['h']}/{c['kvh']} D={c['d']}"
        else:
            b, smax = c["b"], c["smax"]
            q, k, v = attn_inputs(rng, [(b, 1, c["h"], c["d"]),
                                        (b, smax, c["kvh"], c["d"]),
                                        (b, smax, c["kvh"], c["d"])], dtype,
                                  device)
            got = attn_ops.flash_decode(q, k, v, c["pos"], impl="cuda")
            on_card = attn_ops.flash_decode(
                q, k, v, torch.tensor(c["pos"], dtype=torch.int32,
                                      device=device), impl="cuda")
            want = attn_ops.flash_decode(q, k, v, c["pos"], impl="torch")
            plan = flash_kernels.decode_plan(
                b, smax, c["h"], c["kvh"], c["d"], dtype,
                torch.cuda.get_device_properties(device)
                .multi_processor_count)
            chunk = flash_kernels.decode_chunk(c["pos"], plan.grid[0])
            same = torch.equal(on_card, got)
            shape = (f"B={b} Smax={smax} pos={c['pos']} "
                     f"H={c['h']}/{c['kvh']} D={c['d']}, "
                     f"{c['pos'] // chunk + 1} of {plan.grid[0]} chunk(s) "
                     f"of {chunk} live; device pos "
                     f"{'bit-equal' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name}: K7 at a device pos differs "
                                     f"from the host-int launch")
        torch.cuda.synchronize()
        ok, err, scaled = attn_close(got, want, kind, dtype)
        key = f"{kind}_{str(dtype).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        worst[key + "_row_scaled"] = max(worst.get(key + "_row_scaled", 0.0),
                                         scaled)
        log(f"  {name:20s} {str(dtype):15s} {shape}: max abs err "
            f"{err:.3g} (tol {ATTN_TOL[dtype]:g}), row-scaled {scaled:.4g} "
            f"(tol {ATTN_ROW_TOL[kind, dtype]:g}) "
            f"{'ok' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"max abs err {err}, row-scaled {scaled}")
        del q, k, v, got, want
    back_to_back(device, worst)
    planted_faults(device)
    torch.cuda.empty_cache()
    return worst


def back_to_back(device, worst: dict) -> None:
    """K7 called back to back on one cache at positions whose live chunks
    differ (1 to 8 a pair and back), at host ints and at one device pos
    written between launches, all launched before any is checked, as a
    decode run calls it: no state a call leaves behind may reach the
    next."""
    rng = np.random.default_rng(10)
    dt = torch.bfloat16
    q, k, v = attn_inputs(rng, [(LM_BATCH, 1, 24, 128),
                                (LM_BATCH, LM_SEQ, 8, 128),
                                (LM_BATCH, LM_SEQ, 8, 128)], dt, device)
    order = (LM_SEQ - 1, 0, 300, 64, LM_SEQ - 1, 1, LM_SEQ // 2 - 1, 511)
    got = [attn_ops.flash_decode(q, k, v, pos, impl="cuda") for pos in order]
    dev = torch.zeros((), dtype=torch.int32, device=device)
    on_card = []
    for pos in order:           # one device pos, written between launches
        dev.fill_(pos)
        on_card.append(attn_ops.flash_decode(q, k, v, dev, impl="cuda"))
    torch.cuda.synchronize()
    for pos, out, out_dev in zip(order, got, on_card):
        if not torch.equal(out_dev, out):
            raise AssertionError(f"K7 back to back at device pos {pos} "
                                 f"differs from the host-int launch")
        want = attn_ops.flash_decode(q, k, v, pos, impl="torch")
        ok, err, scaled = attn_close(out, want, "k7", dt)
        worst["k7_bfloat16"] = max(worst["k7_bfloat16"], err)
        worst["k7_bfloat16_row_scaled"] = max(
            worst["k7_bfloat16_row_scaled"], scaled)
        if not ok:
            raise AssertionError(f"K7 back to back at pos {pos} differs: "
                                 f"max abs err {err}, row-scaled {scaled}")
    log(f"  K7 back to back at pos {list(order)}: every call within "
        f"its limits, and each at one device pos written between launches "
        f"bit-equal to it")


def _cut(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """x without positions [start, start + n) of axis 1."""
    return torch.cat([x[:, :start], x[:, start + n:]], 1).contiguous()


def planted_faults(device) -> None:
    """Show that phase 7's check rejects the faults a long context hides
    under an absolute limit.  Each faulty output is made by the kernels
    themselves on inputs with positions cut out, so it is exactly what a
    kernel that skipped them would return: K7 at pos 4095 without one
    64-position pass of a block's warps (a tile); K7 on the 8 x 32768 slice
    without one chunk of its split (8,192 positions, the plan's chunk on
    132 SMs); the merge of K7 at pos 4095 without one chunk's partial (its
    512 positions); and K6 causal at S=4096 without one KV tile for the
    query rows after it."""
    rng = np.random.default_rng(9)
    h, kvh, d, dt = 24, 8, 128, torch.bfloat16
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    faults = []
    for b, smax, what in ((LM_BATCH, LM_SEQ, "one tile"),
                          (8, 8 * LM_SEQ, "one chunk"),
                          (LM_BATCH, LM_SEQ, "the merge of one chunk's "
                                             "partial")):
        pos = smax - 1
        plan = flash_kernels.decode_plan(b, smax, h, kvh, d, dt, sms)
        chunk = flash_kernels.decode_chunk(pos, plan.grid[0])
        if what == "one tile":
            start, n = LM_SEQ // 2, flash_kernels.DEC_WARPS * \
                flash_kernels.DEC_TILE
        else:
            start, n = ((pos // chunk + 1) // 2) * chunk, chunk
        q, k, v = attn_inputs(rng, [(b, 1, h, d), (b, smax, kvh, d),
                                    (b, smax, kvh, d)], dt, device)
        want = attn_ops.flash_decode(q, k, v, pos, impl="torch")
        bad = attn_ops.flash_decode(q, _cut(k, start, n), _cut(v, start, n),
                                    pos - n, impl="cuda")
        faults.append((f"K7 B={b} pos={pos} without {what} (positions "
                       f"{start}+{n})", "k7", bad, want))
        del q, k, v
    b, s, start, n = LM_BATCH, LM_SEQ, LM_SEQ // 4, 64
    q, k, v = attn_inputs(rng, [(b, s, h, d), (b, s, kvh, d),
                                (b, s, kvh, d)], dt, device)
    want = attn_ops.flash_attention(q, k, v, causal=True, impl="torch")
    bad = want.clone()
    bad[:, start + n:] = attn_ops.flash_attention(
        *(_cut(x, start, n) for x in (q, k, v)), causal=True,
        impl="cuda")[:, start:]
    faults.append((f"K6 causal B={b} S={s} without KV tile {start}+{n} "
                   f"for later rows", "k6", bad, want))
    del q, k, v
    for what, kind, bad, want in faults:
        ok, err, scaled = attn_close(bad, want, kind, dt)
        within_abs = torch.allclose(bad.float(), want.float(),
                                    atol=ATTN_TOL[dt], rtol=ATTN_TOL[dt])
        log(f"  planted fault, {what}: max abs err {err:.3g} "
            f"({'within' if within_abs else 'beyond'} "
            f"the absolute {ATTN_TOL[dt]:g}), row-scaled {scaled:.4g} (tol "
            f"{ATTN_ROW_TOL[kind, dt]:g}) {'MISSED' if ok else 'rejected'}")
        if ok:
            raise AssertionError(f"phase 7's check passes a planted fault: "
                                 f"{what}")


def attn_bound(ops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of the operations at the
    bf16 peak and the bytes at the HBM rate."""
    t = (ops / H100.peak_flops, nbytes / H100.hbm_bw)
    return max(t) * 1e3, "operations" if t[0] >= t[1] else "bytes"


def k6_timing(rng, device, b, s, h, kvh, d, plain: bool):
    """K6 causal at (B, S, H / Kv, D): (its times, the plain version's ms
    or None, SDPA's times or None, K6 vs SDPA max abs diff, bound ms,
    bound_by)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = attn_inputs(rng, [(b, s, h, d), (b, s, kvh, d),
                                (b, s, kvh, d)], torch.bfloat16, device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    iters = 20 if s <= LM_SEQ else 3
    kern = timed(lambda: attn_ops.flash_attention(q, k, v, causal=True,
                                                  impl="cuda"),
                 iters=iters)
    lib = gap = None
    # SDPA's math backend would build the whole score matrix (103 GB at
    # S=32768): past LM_SEQ only a fused backend may take the call
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.EFFICIENT_ATTENTION]
    if s <= LM_SEQ:
        backends.append(SDPBackend.MATH)
    try:
        with sdpa_kernel(backends):
            lib = timed(lambda: sdpa(qt, kt, vt, is_causal=True,
                                     enable_gqa=True), iters=iters)
            gap = max_abs_err(
                attn_ops.flash_attention(q, k, v, causal=True),
                sdpa(qt, kt, vt, is_causal=True,
                     enable_gqa=True).transpose(1, 2))
    except RuntimeError as err:           # the yardstick only, not the port
        if s <= LM_SEQ:
            raise
        log(f"  SDPA at B={b} S={s}: no fused backend took the call "
            f"({str(err).splitlines()[0]}); not timed")
    plain_ms = (time_ms(lambda: attn_ops.flash_attention(
        q, k, v, causal=True, impl="torch"), iters=3, warmup=1)
        if plain else None)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    return (kern, plain_ms, lib, gap) + attn_bound(2 * b * s * s * h * d,
                                                   nbytes)


def k7_timing(rng, device, b, smax, pos, h, kvh, d):
    """K7 at (B, Smax, pos, H / Kv, D): (its times at the host int, with
    its times at ``pos`` a 0-d int32 on the card under ``"tensor_pos"``,
    the plain version's ms, SDPA's times over the cache up to pos, bound
    ms, bound_by)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = attn_inputs(rng, [(b, 1, h, d), (b, smax, kvh, d),
                                (b, smax, kvh, d)], torch.bfloat16, device)
    kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (k, v))
    qt = q.transpose(1, 2).contiguous()
    kern = timed(lambda: attn_ops.flash_decode(q, k, v, pos, impl="cuda"))
    dev = torch.tensor(pos, dtype=torch.int32, device=device)
    kern["tensor_pos"] = timed(lambda: attn_ops.flash_decode(q, k, v, dev,
                                                             impl="cuda"))
    plain_ms = time_ms(lambda: attn_ops.flash_decode(q, k, v, pos,
                                                     impl="torch"),
                       iters=10)
    lib = timed(lambda: sdpa(qt, kt, vt, enable_gqa=True))
    nbytes = 2 * b * (pos + 1) * kvh * d * 2
    return (kern, plain_ms, lib) + attn_bound(4 * b * (pos + 1) * h * d,
                                              nbytes)


def attention_rows(device, launches: dict, worst: dict) -> list:
    """K6/K7 rows: device and call times (``timed``) against the plain
    version, SDPA (``enable_gqa``, the yardstick; the port never calls it)
    and the bound.  K6: 2*B*S^2*H*D operations (causal) at the bf16 peak,
    or its bytes; K7: the cache read up to pos, 2*B*(pos+1)*Kv*D*2 bytes,
    at the HBM rate, at B=2 pos 287 (the decode run's last step), B=2 pos
    4095 and the 8 x 32768 slice."""
    rng = np.random.default_rng(8)
    h, kvh, d = 24, 8, 128
    before = dict(LAUNCHES)

    k6 = k6_timing(rng, device, LM_BATCH, LM_SEQ, h, kvh, d, plain=True)
    k6_32k = k6_timing(rng, device, 1, 8 * LM_SEQ, h, kvh, d, plain=False)
    k7 = k7_timing(rng, device, LM_BATCH, LM_SEQ, LM_SEQ - 1, h, kvh, d)
    k7_short = k7_timing(rng, device, LM_BATCH, LM_SEQ,
                         LM_FORCED + LM_GREEDY - 1, h, kvh, d)
    k7_32k = k7_timing(rng, device, 8, 8 * LM_SEQ, 8 * LM_SEQ - 1, h, kvh,
                       d)
    LAUNCHES.update(before)      # timing launches not counted
    torch.cuda.empty_cache()
    source = "src/repro_torch/kernels/attention/csrc/flash.cu"
    short = f"_2x{LM_FORCED + LM_GREEDY - 1}"
    lib32k = k6_32k[2] or {"ms_call": None, "ms_device": None}
    rows = [
        {"name": "flash_attention", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/attention/flash.py:95",
         "launches": launches["flash_attention"],
         "launches_counted": "phase 8: the kernel prefill of minitron-4b, "
                             "one launch a layer",
         "max_abs_err": worst["k6_bfloat16"],
         "max_row_scaled_err": worst["k6_bfloat16_row_scaled"],
         "max_abs_err_float32": worst["k6_float32"],
         "max_row_scaled_err_float32": worst["k6_float32_row_scaled"],
         "shape": [LM_BATCH, LM_SEQ, h, kvh, d], "ms": k6[0]["ms_call"],
         "plain_ms": k6[1], "bound_ms": k6[4], "bound_by": k6[5],
         "library_ms": k6[2]["ms_call"],
         "library_ms_device": k6[2]["ms_device"],
         "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) on (B, H, S, D) copies",
         "max_abs_diff_vs_library": k6[3], **device_keys(k6[0]),
         "ms_1x32768": k6_32k[0]["ms_call"],
         "ms_device_1x32768": k6_32k[0]["ms_device"],
         "library_ms_1x32768": lib32k["ms_call"],
         "library_ms_device_1x32768": lib32k["ms_device"],
         "bound_ms_1x32768": k6_32k[4],
         "max_abs_diff_vs_library_1x32768": k6_32k[3]},
        {"name": "flash_decode", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/attention/flash.py:193",
         "launches": launches["flash_decode"],
         "launches_counted": f"phase 8: the kernel decode of minitron-4b, "
                             f"{LM_FORCED + LM_GREEDY} steps of one launch "
                             f"a layer",
         "max_abs_err": worst["k7_bfloat16"],
         "max_row_scaled_err": worst["k7_bfloat16_row_scaled"],
         "max_abs_err_float32": worst["k7_float32"],
         "max_row_scaled_err_float32": worst["k7_float32_row_scaled"],
         "shape": [LM_BATCH, LM_SEQ, LM_SEQ - 1, h, kvh, d],
         "ms": k7[0]["ms_call"], "plain_ms": k7[1], "bound_ms": k7[3],
         "bound_by": k7[4], "library_ms": k7[2]["ms_call"],
         "library_ms_device": k7[2]["ms_device"],
         "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
                         "over the cache up to pos, (B, Kv, pos+1, D) "
                         "copies", **device_keys(k7[0]),
         "plain_ms" + short: k7_short[1], "bound_ms" + short: k7_short[3],
         "library_ms_device" + short: k7_short[2]["ms_device"],
         **device_keys(k7_short[0], short),
         "ms_8x32768": k7_32k[0]["ms_call"], "plain_ms_8x32768": k7_32k[1],
         "library_ms_8x32768": k7_32k[2]["ms_call"],
         "library_ms_device_8x32768": k7_32k[2]["ms_device"],
         "bound_ms_8x32768": k7_32k[3],
         **device_keys(k7_32k[0], "_8x32768")}]
    log(f"  flash_attention B={LM_BATCH} S={LM_SEQ}: {fmt_times(k6[0])} "
        f"(plain {k6[1]:.4f} ms, SDPA {fmt_times(k6[2])}, bound "
        f"{k6[4]:.4f} ms, {k6[4] / k6[0]['ms_device']:.1%} of the bound's "
        f"speed on the device; vs SDPA max abs diff {k6[3]:.3g})")
    log(f"  flash_attention B=1 S={8 * LM_SEQ}: {fmt_times(k6_32k[0])} (SDPA "
        f"{fmt_times(k6_32k[2]) if k6_32k[2] else 'not timed'}, bound "
        f"{k6_32k[4]:.4f} ms, {k6_32k[4] / k6_32k[0]['ms_device']:.1%}; vs "
        f"SDPA max abs diff {k6_32k[3]}, not gated)")
    for (b, pos), t in (((LM_BATCH, LM_FORCED + LM_GREEDY - 1), k7_short),
                        ((LM_BATCH, LM_SEQ - 1), k7),
                        ((8, 8 * LM_SEQ - 1), k7_32k)):
        log(f"  flash_decode B={b} pos={pos}: {fmt_times(t[0])} (plain "
            f"{t[1]:.4f} ms, SDPA {fmt_times(t[2])}, bound {t[3]:.4f} ms, "
            f"{t[3] / t[0]['ms_device']:.1%} of the bound's speed on the "
            f"device; host time of a call "
            f"{t[0]['ms_call'] - t[0]['ms_device']:.4f} ms); at a device "
            f"pos {fmt_times(t[0]['tensor_pos'])}")
    return rows


# --------------------------------------------------------------- phase 8 ----

def lm_decode(cfg, params, tokens, impl, forced_steps: int = LM_FORCED,
              greedy_steps: int = LM_GREEDY, smax: int = LM_SEQ,
              time_step: bool = True) -> dict:
    """Teacher-forced decode over the prompts' first ``forced_steps``
    tokens, then ``greedy_steps`` greedy steps, from an empty ``smax``
    cache; launches counted from 0 just before, read just after; then one
    more step timed (CUDA events) unless ``time_step`` is false.  The
    cache comes back under ``"cache"``: rows 0..forced + greedy - 1
    written (row forced + greedy too when timed, by the last greedy
    choice, the next step's input)."""
    cache = transformer.init_cache(cfg, tokens.shape[0], smax, tokens.device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forced = []
    for pos in range(forced_steps):
        logits, cache = transformer.decode_step(
            cfg, params, tokens[:, pos:pos + 1], cache, pos, impl=impl)
        forced.append(logits[:, 0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chosen, top2 = [], []
    for step in range(greedy_steps + 1):
        top = torch.topk(logits[:, 0].float(), 2, dim=-1)
        chosen.append(top.indices[:, 0])
        top2.append(top.values[:, 0] - top.values[:, 1])
        if step == greedy_steps:
            break
        logits, cache = transformer.decode_step(
            cfg, params, chosen[-1][:, None], cache, forced_steps + step,
            impl=impl)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    step_ms = time_ms(lambda: transformer.decode_step(
        cfg, params, chosen[-1][:, None], cache, forced_steps + greedy_steps,
        impl=impl), iters=10) if time_step else None
    LAUNCHES.update(launches)
    return {"forced": torch.stack(forced, 1), "ids": torch.stack(chosen, 1),
            "margin": torch.stack(top2, 1), "launches": launches,
            "forced_s": t1 - t0, "greedy_s": t2 - t1, "step_ms": step_ms,
            "cache": cache}


def greedy_agreement(kern: dict, plain: dict) -> list:
    """Per row, how many greedy choices agree before the two runs may
    fairly part: the ids must be equal wherever the plain run's top-2
    margin is at least LOGIT_TOL; at a choice with a smaller margin equal
    ids go on being compared, and different ids end the row."""
    compared = []
    for row in range(LM_BATCH):
        ids_k, ids_p = kern["ids"][row].tolist(), plain["ids"][row].tolist()
        margins = plain["margin"][row].tolist()
        n = 0
        for a, b, m in zip(ids_k, ids_p, margins):
            if a != b:
                if m < LOGIT_TOL:
                    break
                raise AssertionError(f"greedy row {row} choice {n}: kernel "
                                     f"token {a}, plain {b} at plain margin "
                                     f"{m:.4f} >= LOGIT_TOL")
            n += 1
        compared.append(n)
    return compared


def lm_phase(device, by_path: dict) -> dict:
    """Phase 8: minitron-4b at full width, random bf16 weights drawn on
    the card; prefill (B=2, S=4096) and decode with the kernels and
    plain, checked against each other and decode against prefill."""
    cfg = configs.get(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(LM_SEED), device)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  param.leaves(params))
    log(f"  built {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: "
        f"{cfg.n_params / 1e9:.3f} B params, {n_bytes / 1e9:.2f} GB, drawn "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, size=(LM_BATCH, LM_SEQ))).to(device)

    runs = {}
    for key, impl in (("kernels", None), ("plain", "torch")):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, h = transformer.prefill(cfg, params, tokens, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[f"lm_prefill_{key}"] = dict(LAUNCHES)
        early = transformer.logits(cfg, params, h[:, :LM_FORCED]).float()
        runs[key] = {"last": last.float(), "early": early, "wall": wall}
        del h
        log(f"  prefill {key}: {wall * 1e3:.1f} ms wall (first call), "
            f"launches {by_path[f'lm_prefill_{key}']}")
        gc.collect()
        torch.cuda.empty_cache()
    check_launches({"launches": by_path["lm_prefill_kernels"]},
                   ("flash_attention",), "LM prefill kernels")
    check_launches({"launches": by_path["lm_prefill_plain"]}, (),
                   "LM prefill plain")
    if by_path["lm_prefill_kernels"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill launched K6 "
                             f"{by_path['lm_prefill_kernels']} times, "
                             f"expected {cfg.n_layers}")
    diffs = {"prefill_last_kernel_vs_plain": max_abs_err(
        runs["kernels"]["last"], runs["plain"]["last"]),
        "prefill_early_kernel_vs_plain": max_abs_err(
        runs["kernels"]["early"], runs["plain"]["early"])}

    dec = {}
    for key, impl in (("kernels", None), ("plain", "torch")):
        dec[key] = lm_decode(cfg, params, tokens, impl)
        by_path[f"lm_decode_{key}"] = dec[key]["launches"]
        steps = LM_FORCED + LM_GREEDY
        log(f"  decode {key}: {LM_FORCED} teacher-forced steps "
            f"{dec[key]['forced_s'] * 1e3 / LM_FORCED:.3f} ms a step, "
            f"{LM_GREEDY} greedy {dec[key]['greedy_s'] * 1e3 / LM_GREEDY:.3f}"
            f" ms a step (host clock); one step at pos {steps}: "
            f"{dec[key]['step_ms']:.3f} ms (CUDA events); launches "
            f"{dec[key]['launches']}")
    check_launches({"launches": by_path["lm_decode_kernels"]},
                   ("flash_decode",), "LM decode kernels")
    check_launches({"launches": by_path["lm_decode_plain"]}, (),
                   "LM decode plain")
    want = (LM_FORCED + LM_GREEDY) * cfg.n_layers
    if by_path["lm_decode_kernels"]["flash_decode"] != want:
        raise AssertionError(f"decode launched K7 "
                             f"{by_path['lm_decode_kernels']} times, "
                             f"expected {want}")
    diffs["decode_vs_prefill_kernels"] = max_abs_err(
        dec["kernels"]["forced"], runs["kernels"]["early"])
    diffs["decode_vs_prefill_plain"] = max_abs_err(
        dec["plain"]["forced"], runs["plain"]["early"])
    diffs["decode_kernel_vs_plain"] = max_abs_err(dec["kernels"]["forced"],
                                                  dec["plain"]["forced"])
    log("  logit differences: " + ", ".join(
        f"{k} {v:.4f}" for k, v in diffs.items()) + f" (LOGIT_TOL "
        f"{LOGIT_TOL})")
    for key, diff in diffs.items():
        if not diff <= LOGIT_TOL:
            raise AssertionError(f"{key}: {diff} > LOGIT_TOL")
    compared = greedy_agreement(dec["kernels"], dec["plain"])
    log(f"  greedy ids equal over {compared} of {LM_GREEDY + 1} choices a "
        f"row (until the ids part where the plain top-2 margin is under "
        f"LOGIT_TOL); plain margins "
        f"{[round(m, 3) for m in dec['plain']['margin'][:, :4].flatten().tolist()]}"
        f"...")
    for row in range(LM_BATCH):
        if not torch.isfinite(dec["kernels"]["forced"][row]).all():
            raise AssertionError("non-finite decode logits")
    del dec["plain"]["cache"]
    return {"cfg": cfg, "params": params, "tokens": tokens, "diffs": diffs,
            # phase 8a decodes on from the kernel run's cache
            "decode_cache": dec["kernels"].pop("cache"),
            "next_ids": dec["kernels"]["ids"][:, -1:],
            "prefill_wall": {k: r["wall"] for k, r in runs.items()},
            "decode": {k: {x: d[x] for x in ("forced_s", "greedy_s",
                                             "step_ms")}
                       for k, d in dec.items()}}


def decode_bytes(cfg, params, pos: int) -> tuple:
    """(weights, cache): the bytes a decode step at ``pos`` must read, the
    layer and lm_head weights (every expert: the dense dispatch reads them
    all) and the bf16 K / V cache up to pos."""
    weights = sum(t.numel() * t.element_size()
                  for name, sub in params.items() if name != "embed"
                  for t in param.leaves(sub))
    cache = 2 * LM_BATCH * (pos + 1) * cfg.n_kv_heads * cfg.head_dim * 2 \
        * cfg.n_layers
    return weights, cache


def capture(fn):
    """``fn`` run once on a side stream (the warm-up a capture needs), then,
    with the launch counters set to 0, captured in a CUDA graph: (the
    graph, the captured call's output, whose tensors each replay
    rewrites)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reset_launches()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def captured_decode(cfg, params, cache: dict, ids, start: int,
                    by_path: dict, key: str) -> dict:
    """Phase 8a: one decode step captured in a CUDA graph, on static
    tokens (``ids``, the last greedy choice), ``pos`` a 0-d int32 on the
    card (``start``) and ``cache`` written in place, then replayed at
    ``CAPTURE_STEPS`` consecutive positions, the greedy token and ``pos +
    1`` written on the card between replays; beside each replay the eager
    step at the host int on a copy of the cache, fed the same token.
    Capture launches K7 once a layer (the host counters, read into
    ``by_path[key]``); a replay launches it without moving them.  Each
    step's routing decisions are recorded in both runs (an MoE model's;
    in the graph too: its top-k indices are rewritten at each replay).
    Returns both runs' logits and routes, whether logits and caches came
    out bit-equal, the replay's time a step (CUDA events around
    back-to-back replays with the token and pos update: the card's time,
    the host only launching graphs), the device's busy time in one
    (``torch.profiler``; None if it records nothing), the eager step's
    time, and the step's byte bound at ``start``."""
    device = ids.device
    eager = clone_cache(cache)
    tok = ids.clone()
    pos = torch.tensor(start, dtype=torch.int32, device=device)
    before = dict(LAUNCHES)
    routes = []

    def step():     # the warm-up writes row `start` as replay 0 does
        routes.clear()
        with recorded_routes(routes):
            return transformer.decode_step(cfg, params, tok, cache, pos)
    graph, (logits, out) = capture(step)
    by_path[key] = dict(LAUNCHES)
    check_launches({"launches": LAUNCHES}, ("flash_decode",),
                   f"{key}: capture")
    if LAUNCHES["flash_decode"] != cfg.n_layers or out is not cache:
        raise AssertionError(f"{key}: capture launched K7 "
                             f"{LAUNCHES['flash_decode']} times (expected "
                             f"{cfg.n_layers}), in place {out is cache}")
    run = {"replay": [], "eager": [], "replay_routes": [],
           "eager_routes": []}
    for i in range(CAPTURE_STEPS):
        eager_routes = []
        with recorded_routes(eager_routes):
            want, eager = transformer.decode_step(cfg, params, tok, eager,
                                                  start + i)
        counts = dict(LAUNCHES)
        graph.replay()
        if LAUNCHES != counts:
            raise AssertionError(f"{key}: a replay moved the launch "
                                 f"counters")
        run["replay"].append(logits[:, 0].clone())
        run["eager"].append(want[:, 0])
        run["replay_routes"].append([r.clone() for r in routes])
        run["eager_routes"].append(eager_routes)
        tok.copy_(logits[:, 0].float().argmax(-1, keepdim=True))
        pos.add_(1)
    torch.cuda.synchronize()
    if int(pos) != start + CAPTURE_STEPS:
        raise AssertionError(f"{key}: pos {int(pos)} after the replays")
    run["replay"] = torch.stack(run["replay"], 1)
    run["eager"] = torch.stack(run["eager"], 1)
    run["same_logits"] = torch.equal(run["replay"], run["eager"])
    run["same_cache"] = all(torch.equal(v, eager[name][k])
                            for name, layer in cache.items()
                            for k, v in layer.items())
    if not torch.isfinite(run["replay"].float()).all():
        raise AssertionError(f"{key}: non-finite replayed logits")

    def serve_step():
        graph.replay()
        tok.copy_(logits[:, 0].float().argmax(-1, keepdim=True))
        pos.add_(1)
    run["replay_ms"] = time_ms(serve_step, iters=10, warmup=1)
    busy = device_busy(serve_step)
    run["busy_ms"] = None if busy is None else busy[0]
    end = start + CAPTURE_STEPS
    run["eager_ms"] = time_ms(lambda: transformer.decode_step(
        cfg, params, tok, eager, end), iters=10, warmup=1)
    run["bound_ms"] = sum(decode_bytes(cfg, params, start)) / H100.hbm_bw \
        * 1e3
    del graph, eager
    LAUNCHES.update(before)     # the eager comparison's launches
    gc.collect()
    torch.cuda.empty_cache()
    return run


def fmt_busy(run: dict) -> str:
    if run["busy_ms"] is None:
        return "the profiler recorded no device activity in a replay"
    return (f"device busy {run['busy_ms']:.3f} ms of it (torch.profiler, "
            f"idle {1 - run['busy_ms'] / run['replay_ms']:.1%}"
            + (": negative, the busy sum exceeds the replay's time, so it "
               "is not a measurement" if run["busy_ms"] > run["replay_ms"]
               else "") + ")")


def captured_phase(lm: dict, by_path: dict) -> None:
    """Phase 8a for minitron-4b: phase 8's kernel cache (rows 0-288 of
    LM_SEQ) decoded on from the last greedy choice by one captured step,
    replayed at positions 288-319; logits and cache bit-equal to the eager
    step at the host int, or within LOGIT_TOL (the tokens fed stay the
    replay's either way)."""
    cfg, params = lm["cfg"], lm["params"]
    start = LM_FORCED + LM_GREEDY
    run = captured_decode(cfg, params, lm.pop("decode_cache"),
                          lm.pop("next_ids"), start, by_path,
                          "lm_decode_graph_capture")
    err = max_abs_err(run["replay"], run["eager"])
    captured = by_path["lm_decode_graph_capture"]["flash_decode"]
    log(f"  captured once (K7 {captured} launches at capture, "
        f"{cfg.n_layers} layers; "
        f"none counted by a replay), replayed at pos {start}-"
        f"{start + CAPTURE_STEPS - 1}: logits "
        f"{'bit-equal' if run['same_logits'] else f'max abs err {err:.4f}'}"
        f" and cache {'bit-equal' if run['same_cache'] else 'DIFFERENT'} "
        f"to the eager step at the host int")
    if not run["same_logits"] and not err <= LOGIT_TOL:
        raise AssertionError(f"captured decode: replayed logits {err} from "
                             f"eager > LOGIT_TOL")
    log(f"  a step: replayed {run['replay_ms']:.3f} ms (CUDA events around "
        f"back-to-back replays with the token and pos update; "
        f"{fmt_busy(run)}), eager "
        f"{run['eager_ms']:.3f} ms at pos {start + CAPTURE_STEPS}; byte "
        f"bound {run['bound_ms']:.3f} ms at pos {start}, the replay "
        f"{run['bound_ms'] / run['replay_ms']:.1%} of the bound's speed, "
        f"the eager step {run['eager_ms'] / run['replay_ms']:.2f}x the replay")


def lm_int8_phase(lm: dict, device, by_path: dict) -> None:
    """Phase 8b: minitron-4b with int8 weights (quantized on the card from
    phase 8's fp weights) and an int8 KV cache: prefill B=2 x LM_INT8_SEQ
    and LM_INT8_STEPS teacher-forced decode steps, K6 / K7 launched,
    against the plain versions and the fp model."""
    cfg, params = lm["cfg"], lm["params"]
    tokens = lm["tokens"][:, :LM_INT8_SEQ].contiguous()
    qcfg = dataclasses.replace(cfg, quant_weights=True, quant_kv=True)
    wcfg = dataclasses.replace(cfg, quant_weights=True)   # bf16 cache
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(transformer.param_specs(qcfg), params)
    torch.cuda.synchronize()
    log(f"  quantized on the card in {time.perf_counter() - t0:.2f}s: "
        f"{weight_bytes(qparams) / 1e9:.2f} GB resident (int8 layers and "
        f"lm_head, bf16 embedding and norms) vs "
        f"{weight_bytes(params) / 1e9:.2f} GB bf16")
    last = {}
    for key, c, p, impl in (("kernels", qcfg, qparams, None),
                            ("plain", qcfg, qparams, "torch"),
                            ("fp", cfg, params, None)):
        reset_launches()
        last[key], h = transformer.prefill(c, p, tokens, impl=impl)
        torch.cuda.synchronize()
        if key != "fp":
            by_path[f"lm_int8_prefill_{key}"] = dict(LAUNCHES)
        if key == "kernels":
            early = transformer.logits(c, p, h[:, :LM_INT8_STEPS]).float()
        del h
    check_launches({"launches": by_path["lm_int8_prefill_kernels"]},
                   ("flash_attention",), "int8 LM prefill kernels")
    check_launches({"launches": by_path["lm_int8_prefill_plain"]}, (),
                   "int8 LM prefill plain")
    if by_path["lm_int8_prefill_kernels"]["flash_attention"] != cfg.n_layers:
        raise AssertionError("int8 prefill: K6 not once a layer")
    diff = max_abs_err(last["kernels"].float(), last["plain"].float())
    corr = correlation(last["kernels"], last["fp"])
    log(f"  int8 prefill B={LM_BATCH} S={LM_INT8_SEQ}: last logits kernels "
        f"vs plain {diff:.4f} (LOGIT_TOL {LOGIT_TOL}); int8 vs fp "
        f"correlation {corr:.5f} (bound > {INT8_LOGIT_CORR})")
    if not diff <= LOGIT_TOL or not corr > INT8_LOGIT_CORR:
        raise AssertionError("int8 prefill outside its bounds")
    dec = {}
    for key, c in (("int8_cache", qcfg), ("bf16_cache", wcfg)):
        cache = transformer.init_cache(c, LM_BATCH, LM_INT8_SEQ, device)
        reset_launches()
        out = []
        for pos in range(LM_INT8_STEPS):
            logits, cache = transformer.decode_step(
                c, qparams, tokens[:, pos:pos + 1], cache, pos)
            out.append(logits[:, 0].float())
        torch.cuda.synchronize()
        by_path[f"lm_int8_decode_{key}"] = dict(LAUNCHES)
        check_launches({"launches": dict(LAUNCHES)}, ("flash_decode",),
                       f"int8 LM decode, {key}")
        if LAUNCHES["flash_decode"] != LM_INT8_STEPS * cfg.n_layers:
            raise AssertionError(f"int8 decode ({key}): K7 launched "
                                 f"{LAUNCHES['flash_decode']} times")
        dec[key] = torch.stack(out, 1)
        if key == "int8_cache" and cache["layer_0"]["k"].dtype != torch.int8:
            raise AssertionError("the int8 cache is not int8")
        del cache
    corr = correlation(dec["int8_cache"], dec["bf16_cache"])
    diff = max_abs_err(dec["bf16_cache"], early)
    log(f"  int8 decode, {LM_INT8_STEPS} teacher-forced steps: int8 cache vs "
        f"bf16 cache logits correlation {corr:.5f} (bound > {INT8_KV_CORR}); "
        f"bf16-cache decode vs int8 prefill logits {diff:.4f} (LOGIT_TOL)")
    if not corr > INT8_KV_CORR or not diff <= LOGIT_TOL:
        raise AssertionError("int8 decode outside its bounds")
    if not all(torch.isfinite(d).all() for d in dec.values()):
        raise AssertionError("non-finite int8 decode logits")
    # one decode step at the same position and cache length, three ways
    step = tokens[:, :1]
    for what, c, p in (("int8 weights, int8 cache", qcfg, qparams),
                       ("int8 weights, bf16 cache", wcfg, qparams),
                       ("bf16 weights, bf16 cache", cfg, params)):
        cache = transformer.init_cache(c, LM_BATCH, LM_INT8_SEQ, device)
        ms = time_ms(lambda: transformer.decode_step(
            c, p, step, cache, LM_INT8_STEPS), iters=10)
        busy = device_busy(lambda: transformer.decode_step(
            c, p, step, cache, LM_INT8_STEPS))
        log(f"  decode step at pos {LM_INT8_STEPS} of a {LM_INT8_SEQ} cache, "
            f"{what}: {ms:.3f} ms (CUDA events)"
            + ("" if busy is None else
               f"; torch.profiler: {busy[1]} device activities, "
               f"{busy[0]:.3f} ms busy, idle share {1 - busy[0] / ms:.1%}"))
        del cache
    for key, c, p in (("int8", qcfg, qparams), ("bf16", cfg, params)):
        ms = time_ms(lambda: transformer.prefill(c, p, tokens), iters=3,
                     warmup=1)
        log(f"  prefill B={LM_BATCH} S={LM_INT8_SEQ}, {key} weights: "
            f"{ms:.2f} ms (CUDA events)")
    log(f"  peak device memory over phase 8b "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()


def device_busy(fn):
    """(ms, count) of the device activity (kernels, copies, fills) of one
    warm call under ``torch.profiler``; None if it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    return sum(e.time_range.elapsed_us() for e in device) / 1e3, len(device)


def lm_split(lm: dict, k6_ms: float) -> None:
    """The prefill's device time by part (CUDA events): embed, K6 over the
    layers, the rest of the layers, lm_head; and a decode step against its
    byte bound (layer and lm_head weights plus the cache read)."""
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    cdt = params["embed"]["embedding"].dtype
    before = dict(LAUNCHES)
    total = time_ms(lambda: transformer.prefill(cfg, params, tokens),
                    iters=3, warmup=1)
    x = layers.embed_lookup(params["embed"], tokens, cdt)
    embed = time_ms(lambda: layers.embed_lookup(params["embed"], tokens,
                                                cdt))
    head = time_ms(lambda: transformer.logits(cfg, params, x[:, -1:]))
    attn = cfg.n_layers * k6_ms
    rest = total - embed - attn - head
    log(f"  prefill B={LM_BATCH} S={LM_SEQ} with kernels: {total:.2f} ms = "
        f"embed {embed:.3f} + K6 {cfg.n_layers} x {k6_ms:.3f} = {attn:.2f} "
        f"({attn / total:.1%}) + rest of the layers {rest:.2f} "
        f"({rest / total:.1%}) + lm_head {head:.3f}; plain prefill "
        f"{lm['prefill_wall']['plain'] * 1e3:.1f} ms wall (one run)")
    pos = LM_FORCED + LM_GREEDY
    weights, cache = decode_bytes(cfg, params, pos)
    bound = (weights + cache) / H100.hbm_bw * 1e3
    for key, d in lm["decode"].items():
        log(f"  decode step {key}: {d['step_ms']:.3f} ms (CUDA events) vs "
            f"byte bound {bound:.3f} ms ({(weights + cache) / 1e9:.2f} GB: "
            f"{weights / 1e9:.2f} GB weights + {cache / 1e6:.1f} MB cache "
            f"at pos {pos}), {bound / d['step_ms']:.1%} of the bound's "
            f"speed")
    kv = transformer.init_cache(cfg, LM_BATCH, LM_SEQ, tokens.device)
    step = tokens[:, :1]
    for what, fn, wall in (
            ("prefill", lambda: transformer.prefill(cfg, params, tokens),
             total),
            ("decode step", lambda: transformer.decode_step(
                cfg, params, step, kv, pos), lm["decode"]["kernels"]
             ["step_ms"])):
        busy = device_busy(fn)
        if busy is None:
            log(f"  {what}: the profiler recorded no device activity; idle "
                f"share not measured")
            continue
        # unclamped: busy above wall would mean overlapping events or a
        # sum counted twice, and must show as such
        log(f"  {what} with kernels, torch.profiler: {busy[1]} device "
            f"activities, {busy[0]:.3f} ms busy of {wall:.3f} ms (CUDA "
            f"events, no profiler): device idle share "
            f"{1 - busy[0] / wall:.1%}"
            + (" (negative: the busy sum exceeds the wall time, so it is "
               "not a measurement)" if busy[0] > wall else ""))
    LAUNCHES.update(before)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")


# --------------------------------------------------------------- phase 8c ----

def zoo_images(gen, batch: int, res: int, device) -> torch.Tensor:
    return torch.randn((batch, res, res, 3), generator=gen, device=device)


def logits_agree(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Kernels vs plain logits (B, classes): every row within ZOO_ROW_TOL
    of its own RMS, and the same top-1 wherever the plain top-2 margin
    exceeds the row's limit."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"{what}: non-finite logits or shapes "
                             f"{tuple(got.shape)} / {tuple(want.shape)}")
    scaled = row_scaled_err(got, want)
    rms = want.pow(2).mean(-1).sqrt()
    top = torch.topk(want, 2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    decided = margin > ZOO_ROW_TOL * rms
    same = got.argmax(-1) == top.indices[:, 0]
    out = {"max_abs_err": max_abs_err(got, want), "row_scaled": scaled,
           "decided": int(decided.sum()), "rows": got.shape[0],
           "top1_equal": int(same.sum())}
    if scaled > ZOO_ROW_TOL or not bool(same[decided].all()):
        raise AssertionError(f"{what}: kernels vs plain {out} (row tol "
                             f"{ZOO_ROW_TOL})")
    return out


def zoo_launches(by_path: dict, key: str, want_k6: int) -> None:
    """The run just made launched K6 ``want_k6`` times and nothing else."""
    got = dict(LAUNCHES)
    by_path[key] = got
    others = {k: v for k, v in got.items() if k != "flash_attention" and v}
    if got["flash_attention"] != want_k6 or others:
        raise AssertionError(f"{key}: launches {got}, expected K6 "
                             f"{want_k6} times and nothing else")


def zoo_busy(fn, wall_ms: float, what: str):
    """The device's busy time over one warm call (``torch.profiler``)
    against its CUDA-event time: the idle share the host leaves."""
    before = dict(LAUNCHES)
    with torch.inference_mode():
        busy = device_busy(fn)
    LAUNCHES.update(before)
    if busy is None:
        log(f"  {what}: the profiler recorded no device activity; idle "
            f"share not measured")
        return None
    log(f"  {what}, torch.profiler: {busy[1]} device activities, "
        f"{busy[0]:.3f} ms busy of {wall_ms:.3f} ms (CUDA events): device "
        f"idle share {1 - busy[0] / wall_ms:.1%}")
    return busy


def vision_zoo(device, by_path: dict) -> dict:
    """ViT-B/16, DeiT-B (224^2, and 384^2 with the position grid resized
    14 -> 24) and ViT-S/16 classifiers, kernels vs plain."""
    out = {}
    for arch, batch, res in ZOO_VISION:
        cfg = configs.get(arch)
        gen = torch.Generator(device=device).manual_seed(ZOO_SEED)
        params = vit.init_params(cfg, gen, device)
        x = zoo_images(gen, batch, res, device)
        tokens = (res // cfg.patch) ** 2 + 1 + cfg.distill_token
        key = f"zoo_{arch}_b{batch}_{res}"
        runs = {}
        for run, impl in (("kernels", "flash"), ("plain", "torch")):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, heads = vit.forward(cfg, params, x, impl=impl,
                                            img_res=res)
            torch.cuda.synchronize()
            runs[run] = (logits, heads, time.perf_counter() - t0)
            zoo_launches(by_path, f"{key}_{run}",
                         cfg.n_layers if run == "kernels" else 0)
        agree = logits_agree(runs["kernels"][0], runs["plain"][0],
                             f"{arch} B={batch} {res}^2")
        if cfg.distill_token:
            for i, head in enumerate(("cls", "distillation")):
                logits_agree(runs["kernels"][1][i], runs["plain"][1][i],
                             f"{arch} {head} head")
        ms = {run: time_ms(lambda impl=impl: vit.serve(cfg, params, x,
                                                       impl=impl),
                           iters=3, warmup=1, windows=1)
              for run, impl in (("kernels", "flash"), ("plain", "torch"))}
        out[key] = {"ms": ms, **agree}
        if (arch, batch, res) == ZOO_VISION[0]:
            out[key]["busy"] = zoo_busy(
                lambda: vit.serve(cfg, params, x, impl="flash"),
                ms["kernels"], f"{arch} B={batch} serve with K6")
        log(f"  {arch} B={batch} {res}^2 ({tokens} tokens, {cfg.n_layers} "
            f"layers, {cfg.n_heads} heads x {cfg.d_model // cfg.n_heads}, "
            f"{cfg.n_params / 1e6:.1f}M params): serve {ms['kernels']:.2f} "
            f"ms with K6, {ms['plain']:.2f} ms plain (CUDA events); logits "
            f"kernels vs plain max abs {agree['max_abs_err']:.4f}, "
            f"row-scaled {agree['row_scaled']:.4f} (tol {ZOO_ROW_TOL}); "
            f"top-1 equal {agree['top1_equal']} / {agree['rows']} rows, "
            f"required on the {agree['decided']} whose plain margin "
            f"exceeds the row limit; K6 {cfg.n_layers} launches")
        del params, x, runs
    torch.cuda.empty_cache()
    return out


def effnet_zoo(device, by_path: dict) -> dict:
    """EfficientNet-B7 at its native 600^2: cuDNN convolutions and no hand
    kernel (the JAX package runs them in XLA); its serve time and peak
    memory, and K1-K7 launched 0 times."""
    arch, batch, res = ZOO_EFFNET
    cfg = configs.get(arch)
    gen = torch.Generator(device=device).manual_seed(ZOO_SEED)
    params = effnet.init_params(cfg, gen, device)
    x = zoo_images(gen, batch, res, device)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = effnet.serve(cfg, params, x)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    zoo_launches(by_path, f"zoo_{arch}_b{batch}_{res}", 0)
    if (logits.shape != (batch, cfg.n_classes)
            or not torch.isfinite(logits.float()).all()
            or not float(logits.float().std()) > 0):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                             f"finite and varied")
    ms = time_ms(lambda: effnet.serve(cfg, params, x), iters=3, warmup=1,
                 windows=1)
    log(f"  {arch} B={batch} {res}^2 ({len(effnet.block_args(cfg))} MBConv "
        f"blocks, {cfg.n_params / 1e6:.2f}M params, {cfg.param_dtype}): "
        f"serve {ms:.2f} ms (CUDA events; first call {first * 1e3:.1f} ms "
        f"wall), peak device memory {peak / 1e9:.2f} GB; K1-K7 0 launches")
    del params, x, logits
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gb": peak / 1e9}


def dit_params(cfg, gen, device) -> dict:
    """Seeded random DiT weights drawn on the card.  adaLN-zero starts the
    modulation and output projections at zero, which would make every
    layer's attention reach nothing; they are drawn N(0, 0.02) instead."""
    params = dit.init_params(cfg, gen, device)
    for sub in [lp["ada"] for lp in params["layers"]] + [
            params["final_ada"], params["final_proj"]]:
        sub["kernel"].normal_(0.0, 0.02, generator=gen)
    return params


def dit_eps_agree(cfg, params, z, labels, what: str, by_path: dict,
                  key: str) -> dict:
    """One forward at t = 999 through K6 and through its plain version."""
    t = torch.full((z.shape[0],), dit.T_MAX - 1, device=z.device)
    eps = {}
    for run, impl in (("kernels", "flash"), ("plain", "torch")):
        reset_launches()
        with torch.inference_mode():
            eps[run] = dit.forward(cfg, params, z, t, labels,
                                   impl=impl).float()
        torch.cuda.synchronize()
        zoo_launches(by_path, f"{key}_eps_{run}",
                     cfg.n_layers if run == "kernels" else 0)
    got, want = eps["kernels"], eps["plain"]
    rms = float(want.pow(2).mean().sqrt())
    err = max_abs_err(got, want)
    if (not torch.isfinite(got).all() or not rms > 0
            or err > DIT_EPS_TOL * rms):
        raise AssertionError(f"{what}: eps kernels vs plain max abs {err} "
                             f"over rms {rms}")
    before = dict(LAUNCHES)
    with torch.inference_mode():
        fwd_ms = {run: time_ms(lambda impl=impl: dit.forward(
            cfg, params, z, t, labels, impl=impl), iters=2, warmup=1,
            windows=1) for run, impl in (("kernels", "flash"),
                                         ("plain", "torch"))}
    LAUNCHES.update(before)      # timing launches not counted
    return {"eps_max_abs_err": err, "eps_scaled": err / rms, "eps_rms": rms,
            "forward_ms": fwd_ms}


def dit_zoo(device, by_path: dict) -> dict:
    """DiT-S/2 and DiT-XL/2 at gen_fast through the kernels and plain (the
    first step's eps, the 4-step sampler's latents); DiT-XL/2 at gen_1024:
    one forward both ways, then the 50-step sampler through K6 alone."""
    out = {}
    for arch, batch, res, steps in ZOO_DIT + (ZOO_DIT_1024,):
        cfg = configs.get(arch)
        gen = torch.Generator(device=device).manual_seed(ZOO_SEED)
        params = dit_params(cfg, gen, device)
        side = res // cfg.vae_factor
        z = torch.randn((batch, side, side, cfg.latent_channels),
                        generator=gen, device=device)
        labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen,
                               device=device)
        key = f"zoo_{arch}_b{batch}_{res}"
        what = f"{arch} B={batch} {res}^2 ({cfg.n_tokens(res)} tokens)"
        rec = dit_eps_agree(cfg, params, z, labels, what, by_path, key)
        fast = (arch, batch, res, steps) != ZOO_DIT_1024
        final, wall = {}, {}
        for run, impl in (("kernels", "flash"), ("plain", "torch")):
            if run == "plain" and not fast:
                break
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            final[run] = dit.ddim_sample(cfg, params, z, labels,
                                         n_steps=steps, impl=impl)
            torch.cuda.synchronize()
            wall[run] = time.perf_counter() - t0
            zoo_launches(by_path, f"{key}_sample_{run}",
                         steps * cfg.n_layers if run == "kernels" else 0)
        if not torch.isfinite(final["kernels"]).all():
            raise AssertionError(f"{what}: non-finite latents")
        rec.update(steps=steps, step_ms={r: w * 1e3 / steps
                                         for r, w in wall.items()},
                   launches=steps * cfg.n_layers)
        if not fast:
            t = torch.full((batch,), dit.T_MAX - 1, device=device)
            rec["busy"] = zoo_busy(
                lambda: dit.forward(cfg, params, z, t, labels, impl="flash"),
                rec["forward_ms"]["kernels"], f"{what} forward with K6")
        line = (f"  {what}, {cfg.n_layers} layers, {cfg.n_heads} heads x "
                f"{cfg.d_model // cfg.n_heads}, {cfg.n_params / 1e6:.1f}M "
                f"params: first-step eps kernels vs plain max abs "
                f"{rec['eps_max_abs_err']:.4f} = {rec['eps_scaled']:.4f} x "
                f"its rms (tol {DIT_EPS_TOL}); a warm forward "
                f"{rec['forward_ms']['kernels']:.1f} ms with K6, "
                f"{rec['forward_ms']['plain']:.1f} ms plain (CUDA events); "
                f"{steps}-step DDIM {rec['step_ms']['kernels']:.1f} ms a "
                f"step with K6 (host clock over the whole first run)")
        if fast:
            corr = correlation(final["kernels"], final["plain"])
            rec["latent_corr"] = corr
            line += (f", {rec['step_ms']['plain']:.1f} ms plain; final "
                     f"latents correlate {corr:.6f} (bound > "
                     f"{DIT_LATENT_CORR})")
            if not corr > DIT_LATENT_CORR:
                raise AssertionError(f"{what}: latents correlate {corr}")
        log(line + f"; K6 {steps} x {cfg.n_layers} launches")
        out[key] = rec
        del params, z, final
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zoo_k6_rows(device, by_path: dict, forward_ms: dict) -> list:
    """K6 at ViT-B/16's serve_b128 layer (B=128, 197 tokens, 12 heads of
    64: the wgmma kernel) and DiT-XL/2's gen_1024 layer (B=4, 4,096
    tokens, 16 heads of 72: the wgmma kernel, laid out at 80), non-causal,
    against the plain version, SDPA (``is_causal=False``; the port never
    calls it) and the bound: 4*B*S^2*H*D operations (the real D) at the
    bf16 peak, or q, k, v and the output once each at the HBM rate,
    whichever is longer."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(ZOO_SEED)
    before = dict(LAUNCHES)
    rows = []
    arch, batch, res = ZOO_VISION[0]
    paths = {arch: f"zoo_{arch}_b{batch}_{res}_kernels"}
    arch, batch, res, _ = ZOO_DIT_1024
    paths[arch] = f"zoo_{arch}_b{batch}_{res}_sample_kernels"
    for model, (b, s, h, d) in ZOO_K6.items():
        path = paths[model]
        q, k, v = attn_inputs(rng, [(b, s, h, d)] * 3, torch.bfloat16,
                              device)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = attn_ops.flash_attention(q, k, v, causal=False, impl="cuda")
        want = attn_ops.flash_attention(q, k, v, causal=False, impl="torch")
        torch.cuda.synchronize()
        ok, err, scaled = attn_close(got, want, "k6", torch.bfloat16)
        if not ok:
            raise AssertionError(f"K6[{model}] differs from its plain "
                                 f"version: {err}, row-scaled {scaled}")
        kern = timed(lambda: attn_ops.flash_attention(q, k, v, causal=False,
                                                      impl="cuda"))
        plain_ms = time_ms(lambda: attn_ops.flash_attention(
            q, k, v, causal=False, impl="torch"), iters=3, warmup=1)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
            lib = timed(lambda: sdpa(qt, kt, vt, is_causal=False))
            gap = max_abs_err(got, sdpa(qt, kt, vt,
                                        is_causal=False).transpose(1, 2))
        ops = 4 * b * s * s * h * d
        nbytes = 4 * q.numel() * q.element_size()
        t = (ops / H100.peak_flops, nbytes / H100.hbm_bw)
        rows.append({
            "name": f"K6[{model}]", "kernel": "flash_attention",
            "model": model, "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/flash.cu",
            "replaces": "src/repro/kernels/attention/flash.py:95",
            "k6_kernel": flash_kernels.k6_kernel(q.dtype, d),
            "launches": by_path[path]["flash_attention"],
            "launches_counted": f"phase 8c: {path}",
            "launches_by_path": {p: c["flash_attention"]
                                 for p, c in by_path.items()
                                 if p.startswith(f"zoo_{model}")},
            "max_abs_err": err, "max_row_scaled_err": scaled,
            "shape": [b, s, h, d], "causal": False,
            "ms": kern["ms_call"], "plain_ms": plain_ms,
            "bound_ms": max(t) * 1e3,
            "bound_by": "operations" if t[0] >= t[1] else "bytes",
            "library_ms": lib["ms_call"],
            "library_ms_device": lib["ms_device"],
            "library_call": "F.scaled_dot_product_attention(is_causal="
                            "False) on (B, H, S, D) copies",
            "max_abs_diff_vs_library": gap, **device_keys(kern)})
        layers_n = configs.get(model).n_layers
        fwd = forward_ms[model]
        log(f"  K6[{model}]: {layers_n} x {kern['ms_device']:.4f} ms = "
            f"{layers_n * kern['ms_device']:.2f} ms of a {fwd:.2f} ms "
            f"forward ({layers_n * kern['ms_device'] / fwd:.1%}; plain "
            f"{layers_n * plain_ms:.2f} ms)")
        log(f"  K6[{model}] B={b} S={s} H={h} D={d} non-causal "
            f"({rows[-1]['k6_kernel']}): {fmt_times(kern)} (plain "
            f"{plain_ms:.4f} ms, SDPA {fmt_times(lib)}, bound "
            f"{rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']} for "
            f"{ops / 1e9:.1f} GFLOP / {nbytes / 1e6:.1f} MB, "
            f"{rows[-1]['bound_ms'] / kern['ms_device']:.1%} of the bound's "
            f"speed on the device; max abs err {err:.3g}, row-scaled "
            f"{scaled:.4f}; vs SDPA {gap:.3g})")
        del q, k, v, qt, kt, vt, got, want
    LAUNCHES.update(before)      # timing launches not counted
    torch.cuda.empty_cache()
    return rows


def zoo_phase(device, by_path: dict) -> list:
    """Phase 8c: the vision and diffusion zoo at full width; returns the
    K6[vit-b16] and K6[dit-xl2] kernel rows."""
    torch.cuda.reset_peak_memory_stats()
    vision = vision_zoo(device, by_path)
    dits = dit_zoo(device, by_path)
    effnet_zoo(device, by_path)
    arch, batch, res = ZOO_VISION[0]
    forward_ms = {arch: vision[f"zoo_{arch}_b{batch}_{res}"]["ms"]
                  ["kernels"]}
    arch, batch, res, _ = ZOO_DIT_1024
    forward_ms[arch] = dits[f"zoo_{arch}_b{batch}_{res}"]["forward_ms"][
        "kernels"]
    rows = zoo_k6_rows(device, by_path, forward_ms)
    log(f"  peak device memory over phase 8c "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return rows


# --------------------------------------------------------------- phase 8d ----

@contextlib.contextmanager
def recorded_routes(routes: list):
    """While inside, append every MoE block's routing decisions to
    ``routes``, one (G, S, k) tensor a layer: each token's top-k expert
    ids in the order the k argmax rounds take them (ties aside)."""
    inner = moe._top_k_dispatch

    def record(gates, cfg, cap):
        routes.append(torch.topk(gates, cfg.top_k, dim=-1).indices)
        return inner(gates, cfg, cap)
    moe._top_k_dispatch = record
    try:
        yield routes
    finally:
        moe._top_k_dispatch = inner


def logit_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The correlation of two logit tensors and the median, 99th
    percentile and max of |got - want| over every logit."""
    d = (got.float() - want.float()).abs().flatten()

    def quantile(f: float) -> float:
        return float(d.kthvalue(max(1, math.ceil(f * d.numel()))).values)
    return {"corr": correlation(got, want), "median": quantile(0.5),
            "p99": quantile(0.99), "max": float(d.max())}


def fmt_stats(st: dict) -> str:
    return (f"corr {st['corr']:.6f}, |dlogit| median {st['median']:.4f}, "
            f"p99 {st['p99']:.4f}, max {st['max']:.4f}")


def hold_stats(st: dict, what: str, kind: str, fails: list) -> None:
    """Print a comparison's statistics; add it to ``fails`` if they are
    outside ``MOE_LIMITS[kind]`` (the phase raises once everything is
    printed)."""
    corr, median, p99 = MOE_LIMITS[kind]
    log(f"  {what}: {fmt_stats(st)} (limits: corr >= {corr}, median <= "
        f"{median}, p99 <= {p99})")
    if not (st["corr"] >= corr and st["median"] <= median
            and st["p99"] <= p99):
        fails.append(f"{what}: {st}")


def moe_launches(by_path: dict, prefix: str, kernel: str, want: int):
    """The kernel run launched ``kernel`` exactly ``want`` times and
    nothing else; the plain run nothing."""
    kern = by_path[f"{prefix}_kernels"]
    check_launches({"launches": kern}, (kernel,), f"{prefix} kernels")
    check_launches({"launches": by_path[f"{prefix}_plain"]}, (),
                   f"{prefix} plain")
    if kern[kernel] != want:
        raise AssertionError(f"{prefix}: {kernel} launched {kern[kernel]} "
                             f"times, expected {want}")


def moe_prefill(cfg, params, tokens, by_path: dict) -> dict:
    """Prefill through the kernels and plain, each run's routing decisions
    recorded; launches counted from 0 just before each, read just
    after."""
    runs = {}
    for key, impl in (("kernels", None), ("plain", "torch")):
        routes = []
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_routes(routes):
            last, h = transformer.prefill(cfg, params, tokens, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[f"moe_prefill_{key}"] = dict(LAUNCHES)
        early = transformer.logits(cfg, params, h[:, :MOE_FORCED]).float()
        runs[key] = {"last": last.float(), "early": early, "wall": wall,
                     "routes": routes}
        del h
        log(f"  prefill {key}: {wall * 1e3:.1f} ms wall (first call, "
            f"routes recorded), launches {by_path[f'moe_prefill_{key}']}")
        gc.collect()
        torch.cuda.empty_cache()
    moe_launches(by_path, "moe_prefill", "flash_attention", cfg.n_layers)
    return runs


def route_agreement(kern: torch.Tensor, plain: torch.Tensor):
    """(ordered, as sets): the share of routing decisions (token, choice)
    equal in two runs' (G, S, k) expert ids, choice by choice; and the
    share of each token's chosen experts the other run chose too."""
    ordered = float((kern == plain).float().mean())
    sets = float((kern[..., :, None] == plain[..., None, :]).any(-1)
                 .float().mean())
    return ordered, sets


def layer_agreement(runs: dict, n_layers: int) -> list:
    """Per layer, the two prefills' routing agreement (ordered, as sets);
    the differences of every earlier layer compound into it."""
    kern, plain = runs["kernels"]["routes"], runs["plain"]["routes"]
    if len(kern) != n_layers or len(plain) != n_layers:
        raise AssertionError(f"routes of {len(kern)} / {len(plain)} layers "
                             f"recorded, expected {n_layers}")
    agree = [route_agreement(a, b) for a, b in zip(kern, plain)]
    log(f"  routing decisions equal, kernels vs plain prefill, per layer "
        f"(ordered by round / as sets), differences compounding: "
        f"{[(round(a, 4), round(b, 4)) for a, b in agree]}")
    return agree


def moe_layerwise(run: tuple, ref: tuple, tokens) -> list:
    """Each layer fed one input (``run``'s hidden state) through ``run``
    and through ``ref`` (each a (cfg, params, impl)), so no earlier
    difference reaches it: per layer the routing agreement (ordered, as
    sets), the output's difference over its RMS and the outputs'
    correlation.  Launches are not counted."""
    cfg = run[0]
    cdt = dtype_of(cfg.compute_dtype)
    before = dict(LAUNCHES)
    x = layers.embed_lookup(run[1]["embed"], tokens, cdt)
    out = []
    for i in range(cfg.n_layers):
        res = []
        for c, p, impl in (run, ref):
            routes = []
            with recorded_routes(routes):
                y, _ = transformer._layer(c, p["layers"][f"layer_{i}"], x,
                                          None, impl)
            res.append((y, routes[0]))
        (y, r), (y_ref, r_ref) = res
        d = (y.float() - y_ref.float()).pow(2).mean().sqrt()
        rel = float(d / y_ref.float().pow(2).mean().sqrt())
        out.append(route_agreement(r, r_ref) + (rel, correlation(y, y_ref)))
        x = y
        del res, y_ref
    LAUNCHES.update(before)
    return out


def fmt_layers(rows: list) -> str:
    return str([tuple(round(v, 4) for v in row) for row in rows])


def moe_nodrop(cfg, params, tokens, by_path: dict, fails: list) -> dict:
    """Decode against prefill where nothing drops: capacity_factor =
    n_experts / top_k makes every group's capacity its size, so the
    groups' differences (a prefill group of 512 tokens, a decode group of
    the batch) route every token alike.  Kernels only: K6 in the prefill
    of B=2 x MOE_NODROP_SEQ, K7 in MOE_FORCED teacher-forced steps."""
    m = cfg.moe
    ncfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    for gs in (m.group_size, tokens.shape[0]):
        if moe.capacity(gs, ncfg.moe) < gs:
            raise AssertionError(f"no-drop capacity short at group {gs}")
    ntok = tokens[:, :MOE_NODROP_SEQ].contiguous()
    reset_launches()
    h, _ = transformer.forward(ncfg, params, ntok)
    want = transformer.logits(ncfg, params, h[:, :MOE_FORCED]).float()
    torch.cuda.synchronize()
    by_path["moe_nodrop_prefill_kernels"] = dict(LAUNCHES)
    del h
    dec = lm_decode(ncfg, params, ntok, None, MOE_FORCED, 0,
                    smax=MOE_NODROP_SEQ, time_step=False)
    by_path["moe_nodrop_decode_kernels"] = dec["launches"]
    if (by_path["moe_nodrop_prefill_kernels"]["flash_attention"]
            != cfg.n_layers or dec["launches"]["flash_decode"]
            != MOE_FORCED * cfg.n_layers):
        raise AssertionError("no-drop runs: K6 / K7 not once a layer")
    st = logit_stats(dec["forced"], want)
    hold_stats(st, f"no-drop (capacity factor {ncfg.moe.capacity_factor:.4g}"
                   f") decode positions 0-{MOE_FORCED - 1} vs prefill of "
                   f"B={tokens.shape[0]} x {MOE_NODROP_SEQ}", "no-drop",
               fails)
    return st


def moe_captured(cfg, params, dec: dict, by_path: dict,
                 fails: list) -> None:
    """Phase 8a for deepseek-moe-16b: the kernel decode's cache (rows
    0-79) decoded on by one captured step, replayed at positions 80-111
    against the eager step at the host int, held as phase 8d holds kernels
    against plain: per layer the routing decisions of the 32 steps
    (ordered, as sets; each step's differences compound over the layers),
    and the logits' statistics (``MOE_LIMITS``); bit-equal logits and
    cache are reported as such."""
    start = MOE_FORCED + MOE_GREEDY
    del dec["plain"]["cache"]
    run = captured_decode(cfg, params, dec["kernels"].pop("cache"),
                          dec["kernels"]["ids"][:, -1:], start, by_path,
                          "moe_decode_graph_capture")
    if any(len(r) != cfg.n_layers for r in
           run["replay_routes"] + run["eager_routes"]):
        raise AssertionError("phase 8a: routes not recorded once a layer")
    agree = [route_agreement(
        torch.cat([step[i] for step in run["replay_routes"]]),
        torch.cat([step[i] for step in run["eager_routes"]]))
        for i in range(cfg.n_layers)]
    least = min(a for a, _ in agree)
    sets = min(b for _, b in agree)
    captured = by_path["moe_decode_graph_capture"]["flash_decode"]
    log(f"  captured once (K7 {captured} launches at capture, "
        f"{cfg.n_layers} layers; "
        f"none counted by a replay), replayed at pos {start}-"
        f"{start + CAPTURE_STEPS - 1}: logits "
        f"{'bit-equal' if run['same_logits'] else 'not bit-equal'} and "
        f"cache {'bit-equal' if run['same_cache'] else 'not bit-equal'} to "
        f"the eager step at the host int; routing decisions equal, least "
        f"over the layers {least:.4f} ordered, {sets:.4f} as sets (limit "
        f"{MOE_ROUTE_SETS})")
    hold_stats(logit_stats(run["replay"], run["eager"]),
               f"replayed vs eager decode logits, pos {start}-"
               f"{start + CAPTURE_STEPS - 1}", "kernels vs plain", fails)
    if sets < MOE_ROUTE_SETS:
        fails.append(f"captured decode routing: least as sets {sets}")
    log(f"  a step: replayed {run['replay_ms']:.3f} ms (CUDA events around "
        f"back-to-back replays with the token and pos update; each replay "
        f"also records its {cfg.n_layers} layers' top-k ids; "
        f"{fmt_busy(run)}), eager "
        f"{run['eager_ms']:.3f} ms at pos {start + CAPTURE_STEPS}; byte "
        f"bound {run['bound_ms']:.3f} ms at pos {start}, the replay "
        f"{run['bound_ms'] / run['replay_ms']:.1%} of the bound's speed, "
        f"the eager step {run['eager_ms'] / run['replay_ms']:.2f}x the replay")


def moe_int8(cfg, params, tokens, by_path: dict, fails: list) -> dict:
    """int8 expert, shared, attention and lm_head kernels quantized on the
    card by the port's quantizer (expert scales over the middle axis);
    prefill B=2 x MOE_INT8_SEQ through K6 against the bf16 model, end to
    end (MOE_LIMITS["int8"]) and each layer on one input (outputs
    correlating above MOE_INT8_CORR)."""
    qcfg = dataclasses.replace(cfg, quant_weights=True)
    itok = tokens[:, :MOE_INT8_SEQ].contiguous()
    t0 = time.perf_counter()
    qparams = quantize_params(transformer.param_specs(qcfg), params)
    torch.cuda.synchronize()
    resident = weight_bytes(qparams)
    log(f"  quantized on the card in {time.perf_counter() - t0:.2f}s: "
        f"{resident / 1e9:.2f} GB resident (int8 kernels, float32 router "
        f"and scales, bf16 embedding and norms) vs "
        f"{weight_bytes(params) / 1e9:.2f} GB bf16")
    reset_launches()
    qlast, h = transformer.prefill(qcfg, qparams, itok)
    torch.cuda.synchronize()
    by_path["moe_int8_prefill_kernels"] = dict(LAUNCHES)
    del h
    check_launches({"launches": by_path["moe_int8_prefill_kernels"]},
                   ("flash_attention",), "int8 MoE prefill")
    if by_path["moe_int8_prefill_kernels"]["flash_attention"] != \
            cfg.n_layers:
        raise AssertionError("int8 MoE prefill: K6 not once a layer")
    before = dict(LAUNCHES)
    flast, h = transformer.prefill(cfg, params, itok)
    del h
    st = logit_stats(qlast, flast)
    hold_stats(st, f"int8 prefill B={LM_BATCH} S={MOE_INT8_SEQ}, last "
                   f"logits vs the bf16 model's", "int8", fails)
    if not torch.isfinite(qlast).all():
        fails.append("non-finite int8 logits")
    per_layer = moe_layerwise((qcfg, qparams, None), (cfg, params, None),
                              itok)
    least = min(row[3] for row in per_layer)
    log(f"  int8 vs bf16, each layer on one input (ordered, as sets, output "
        f"difference / RMS, correlation): {fmt_layers(per_layer)}; least "
        f"correlation {least:.5f} (bound > {MOE_INT8_CORR})")
    if not least > MOE_INT8_CORR:
        fails.append(f"int8 layer outputs correlate {least}")
    ms = {key: time_ms(lambda c=c, p=p: transformer.prefill(c, p, itok),
                       iters=2, warmup=1, windows=1)
          for key, c, p in (("int8", qcfg, qparams), ("bf16", cfg, params))}
    LAUNCHES.update(before)
    log(f"  prefill B={LM_BATCH} S={MOE_INT8_SEQ}: {ms['int8']:.2f} ms int8, "
        f"{ms['bf16']:.2f} ms bf16 (CUDA events)")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"resident_gb": resident / 1e9, **st, "ms": ms,
            "layers": per_layer}


def moe_attention_rows(device, by_path: dict) -> list:
    """K6 and K7 at deepseek-moe-16b's shapes (16 query heads over 16 KV
    heads, G = 1, D 128): K6 causal at B=2 S=4096, K7 at B=2 pos 4095 of
    a 4096 cache; each against its plain version (ATTN_TOL and the row
    limit), SDPA and its bound (``attention_rows``' rules)."""
    cfg = configs.get(MOE_ARCH)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(MOE_SEED)
    before = dict(LAUNCHES)
    dt = torch.bfloat16
    q, k, v = attn_inputs(rng, [(LM_BATCH, LM_SEQ, h, d),
                                (LM_BATCH, LM_SEQ, kvh, d),
                                (LM_BATCH, LM_SEQ, kvh, d)], dt, device)
    ok6, err6, sc6 = attn_close(
        attn_ops.flash_attention(q, k, v, causal=True, impl="cuda"),
        attn_ops.flash_attention(q, k, v, causal=True, impl="torch"),
        "k6", dt)
    q1 = q[:, -1:].contiguous()
    got7 = attn_ops.flash_decode(q1, k, v, LM_SEQ - 1, impl="cuda")
    ok7, err7, sc7 = attn_close(
        got7, attn_ops.flash_decode(q1, k, v, LM_SEQ - 1, impl="torch"),
        "k7", dt)
    ok7 = ok7 and torch.equal(got7, attn_ops.flash_decode(
        q1, k, v, torch.tensor(LM_SEQ - 1, dtype=torch.int32, device=device),
        impl="cuda"))
    if not (ok6 and ok7):
        raise AssertionError(f"K6 / K7 at {MOE_ARCH}'s shapes differ from "
                             f"their plain versions (K7 also from itself at "
                             f"a device pos): {err6}, {sc6}; {err7}, {sc7}")
    del q, k, v, q1
    k6 = k6_timing(rng, device, LM_BATCH, LM_SEQ, h, kvh, d, plain=True)
    k7 = k7_timing(rng, device, LM_BATCH, LM_SEQ, LM_SEQ - 1, h, kvh, d)
    LAUNCHES.update(before)      # timing launches not counted
    torch.cuda.empty_cache()
    source = "src/repro_torch/kernels/attention/csrc/flash.cu"
    rows = [
        {"name": f"K6[{MOE_ARCH}]", "kernel": "flash_attention",
         "model": MOE_ARCH, "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/attention/flash.py:95",
         "k6_kernel": flash_kernels.k6_kernel(dt, d),
         "launches": by_path["moe_prefill_kernels"]["flash_attention"],
         "launches_counted": f"phase 8d: the kernel prefill of {MOE_ARCH}, "
                             f"one launch a layer",
         "launches_by_path": {p: c["flash_attention"]
                              for p, c in by_path.items()
                              if p.startswith("moe_")},
         "max_abs_err": err6, "max_row_scaled_err": sc6,
         "shape": [LM_BATCH, LM_SEQ, h, kvh, d], "causal": True,
         "ms": k6[0]["ms_call"], "plain_ms": k6[1], "bound_ms": k6[4],
         "bound_by": k6[5], "library_ms": k6[2]["ms_call"],
         "library_ms_device": k6[2]["ms_device"],
         "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) on (B, H, S, D) copies",
         "max_abs_diff_vs_library": k6[3], **device_keys(k6[0])},
        {"name": f"K7[{MOE_ARCH}]", "kernel": "flash_decode",
         "model": MOE_ARCH, "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/attention/flash.py:193",
         "launches": by_path["moe_decode_kernels"]["flash_decode"],
         "launches_counted": f"phase 8d: the kernel decode of {MOE_ARCH}, "
                             f"{MOE_FORCED + MOE_GREEDY} steps of one "
                             f"launch a layer",
         "launches_by_path": {p: c["flash_decode"]
                              for p, c in by_path.items()
                              if p.startswith("moe_")},
         "max_abs_err": err7, "max_row_scaled_err": sc7,
         "shape": [LM_BATCH, LM_SEQ, LM_SEQ - 1, h, kvh, d],
         "ms": k7[0]["ms_call"], "plain_ms": k7[1], "bound_ms": k7[3],
         "bound_by": k7[4], "library_ms": k7[2]["ms_call"],
         "library_ms_device": k7[2]["ms_device"],
         "library_call": "F.scaled_dot_product_attention(enable_gqa=True) "
                         "over the cache up to pos, (B, Kv, pos+1, D) "
                         "copies", **device_keys(k7[0])}]
    for row, what in ((rows[0], f"flash_attention B={LM_BATCH} "
                                f"S={LM_SEQ} H={h}/{kvh} D={d} causal"),
                      (rows[1], f"flash_decode B={LM_BATCH} "
                                f"pos={LM_SEQ - 1} H={h}/{kvh} D={d}")):
        t = {k: row[k] for k in ("ms_call", "ms_device",
                                 "ms_device_profiler")}
        log(f"  {row['name']}, {what}: {fmt_times(t)} (plain "
            f"{row['plain_ms']:.4f} ms, SDPA device "
            f"{row['library_ms_device']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{row['bound_ms'] / row['ms_device']:.1%} of the bound's speed "
            f"on the device; max abs err {row['max_abs_err']:.3g}, "
            f"row-scaled {row['max_row_scaled_err']:.4f})"
            + (f"; at a device pos device {row['ms_device_tensor_pos']:.4f}"
               f" ms, call {row['ms_call_tensor_pos']:.4f} ms"
               if "ms_device_tensor_pos" in row else ""))
    return rows


def moe_split(cfg, params, tokens, k6_ms: float, dec: dict) -> None:
    """The prefill's device time by part (CUDA events): embed, then per
    layer (on layer 0's inputs, times the layers) the attention
    projections and RoPE, K6, the router and top-k rounds, the dispatch
    einsum, the expert einsums (wg, wu, SiLU, wd), the combine einsum and
    the shared expert, the norms and residuals as what is left, lm_head;
    a decode step against its byte bound; device busy shares."""
    cdt = dtype_of(cfg.compute_dtype)
    m, L = cfg.moe, cfg.n_layers
    before = dict(LAUNCHES)
    total = time_ms(lambda: transformer.prefill(cfg, params, tokens),
                    iters=2, warmup=1, windows=1)
    lp = params["layers"]["layer_0"]
    x = layers.embed_lookup(params["embed"], tokens, cdt)
    embed = time_ms(lambda: layers.embed_lookup(params["embed"], tokens,
                                                cdt))
    hn = layers.rmsnorm(lp["ln_attn"], x, cfg.norm_eps, cdt)

    def attention():
        return attn_lib.attention(lp["attn"], hn, n_heads=cfg.n_heads,
                                  n_kv_heads=cfg.n_kv_heads,
                                  rope_theta=cfg.rope_theta,
                                  compute_dtype=cdt)
    hm = layers.rmsnorm(lp["ln_mlp"], x + attention(), cfg.norm_eps, cdt)
    mp = lp["moe"]
    b, s, d = hm.shape
    gs = min(m.group_size, b * s)
    cap = moe.capacity(gs, m)
    xt = hm.reshape(-1, gs, d)

    def route():
        logits = torch.einsum("gsd,de->gse", xt.float(),
                              mp["router"].float())
        disp, comb, _ = moe._top_k_dispatch(torch.softmax(logits, -1), m,
                                            cap)
        return disp.to(cdt), comb.to(cdt)

    def experts(e_in):
        w = {n: moe._eweight(mp[n], cdt) for n in ("wg", "wu", "wd")}
        hh = layers.silu(torch.einsum("gecd,edf->gecf", e_in, w["wg"])) \
            * torch.einsum("gecd,edf->gecf", e_in, w["wu"])
        return torch.einsum("gecf,efd->gecd", hh, w["wd"])
    disp, comb = route()
    e_in = torch.einsum("gsec,gsd->gecd", disp, xt)
    e_out = experts(e_in)
    one = dict(iters=3, warmup=1, windows=1)
    parts = {
        "attention projections and RoPE": time_ms(attention, **one) - k6_ms,
        "K6": k6_ms,
        "router and top-k rounds": time_ms(route, **one),
        "dispatch einsum": time_ms(
            lambda: torch.einsum("gsec,gsd->gecd", disp, xt), **one),
        "expert einsums": time_ms(lambda: experts(e_in), **one),
        "combine einsum": time_ms(
            lambda: torch.einsum("gsec,gecd->gsd", comb, e_out), **one),
        "shared expert": time_ms(
            lambda: layers.swiglu(mp["shared"], hm, cdt), **one)}
    head = time_ms(lambda: transformer.logits(cfg, params, x[:, -1:]))
    rest = total - embed - head - L * sum(parts.values())
    einsum_flop = 2 * (b * s // gs) * gs * m.n_experts * cap * d
    log(f"  prefill B={b} S={s} with kernels: {total:.2f} ms (CUDA events) "
        f"= embed {embed:.3f} + {L} layers x {sum(parts.values()):.3f} + "
        f"norms and residuals {rest:.2f} + lm_head {head:.3f}"
        + (" (negative: the parts, timed one by one, add up to more than "
           "the whole)" if rest < 0 else "")
        + f"; a layer on layer 0's inputs (groups of {gs}, capacity {cap}):")
    for name, ms in parts.items():
        log(f"    {name:31s} {ms:8.3f} ms a layer, {L * ms:8.2f} ms "
            f"({L * ms / total:.1%})")
    pair_ms = parts["dispatch einsum"] + parts["combine einsum"]
    log(f"    dispatch and combine einsums: {2 * einsum_flop / 1e12:.3f} "
        f"TFLOP a layer, {2 * einsum_flop / 1e9 / pair_ms:.1f} TFLOP/s")
    del disp, comb, e_in, e_out, hm, hn, x
    pos = MOE_FORCED + MOE_GREEDY
    weights, cache = decode_bytes(cfg, params, pos)
    bound = (weights + cache) / H100.hbm_bw * 1e3
    for key, dd in dec.items():
        log(f"  decode step {key}: {dd['step_ms']:.3f} ms (the teacher-"
            f"forced steps' mean) vs byte bound {bound:.3f} ms ({(weights + cache) / 1e9:.2f} GB: "
            f"{weights / 1e9:.2f} GB weights, every expert read by the "
            f"dense dispatch, + {cache / 1e6:.1f} MB cache at pos {pos}), "
            f"{bound / dd['step_ms']:.1%} of the bound's speed")
    kv = transformer.init_cache(cfg, LM_BATCH, LM_SEQ, tokens.device)
    step = tokens[:, :1]
    for what, fn, wall in (
            ("prefill", lambda: transformer.prefill(cfg, params, tokens),
             total),
            ("decode step", lambda: transformer.decode_step(
                cfg, params, step, kv, pos), dec["kernels"]["step_ms"])):
        busy = device_busy(fn)
        if busy is None:
            log(f"  {what}: the profiler recorded no device activity; idle "
                f"share not measured")
            continue
        log(f"  {what} with kernels, torch.profiler: {busy[1]} device "
            f"activities, {busy[0]:.3f} ms busy of {wall:.3f} ms (as "
            f"above, no profiler): device idle share "
            f"{1 - busy[0] / wall:.1%}")
    LAUNCHES.update(before)
    del kv


def moe_phase(device, by_path: dict) -> list:
    """Phase 8d: deepseek-moe-16b at full width, random bf16 weights drawn
    on the card; prefill (B=2, S=4096) and decode with the kernels and
    plain, held by routing agreement and logit statistics; decode against
    prefill without drops; int8 weights; the prefill split and a decode
    step against its byte bound.  Returns the K6[deepseek-moe-16b] and
    K7[deepseek-moe-16b] rows."""
    cfg = configs.get(MOE_ARCH)
    m = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(MOE_SEED), device)
    torch.cuda.synchronize()
    log(f"  built {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
        f"{m.n_experts} experts top-{m.top_k} and {m.n_shared} shared of "
        f"{m.d_ff_expert}, vocab {cfg.vocab}, {cfg.param_dtype}: "
        f"{cfg.n_params / 1e9:.3f} B params ({cfg.n_active_params / 1e9:.3f}"
        f" B active a token), {weight_bytes(params) / 1e9:.2f} GB, drawn on "
        f"the card in {time.perf_counter() - t0:.1f}s")
    tokens = torch.from_numpy(np.random.default_rng(MOE_SEED).integers(
        0, cfg.vocab, size=(LM_BATCH, LM_SEQ))).to(device)
    gs = min(m.group_size, LM_BATCH * LM_SEQ)
    log(f"  GShard dispatch: prefill {LM_BATCH * LM_SEQ // gs} groups of "
        f"{gs} tokens at capacity {moe.capacity(gs, m)}; a decode step one "
        f"group of {LM_BATCH} at capacity {moe.capacity(LM_BATCH, m)}")

    runs = moe_prefill(cfg, params, tokens, by_path)
    compounded = layer_agreement(runs, cfg.n_layers)
    for r in runs.values():
        del r["routes"]
    layerwise = moe_layerwise((cfg, params, None), (cfg, params, "torch"),
                              tokens)
    log(f"  each layer on one input, kernels vs plain (ordered, as sets, "
        f"output difference / RMS, correlation): {fmt_layers(layerwise)}")
    fails = []
    least = min(row[0] for row in layerwise)
    largest = max(row[2] for row in layerwise)
    sets = min(b for _, b in compounded)
    log(f"  each layer on one input: least routing agreement {least:.4f} "
        f"(limit {MOE_ROUTE_AGREE}), largest output difference "
        f"{largest:.4f} of its RMS (limit {MOE_LAYER_TOL}); compounded: "
        f"least agreement as sets {sets:.4f} (limit {MOE_ROUTE_SETS})")
    if (least < MOE_ROUTE_AGREE or largest > MOE_LAYER_TOL
            or sets < MOE_ROUTE_SETS):
        fails.append(f"routing: layer-wise {least} / output {largest}, "
                     f"compounded sets {sets}")
    stats = {"prefill last logits": logit_stats(runs["kernels"]["last"],
                                                runs["plain"]["last"]),
             f"prefill logits 0-{MOE_FORCED - 1}": logit_stats(
                 runs["kernels"]["early"], runs["plain"]["early"])}
    dec = {}
    for key, impl in (("kernels", None), ("plain", "torch")):
        dec[key] = lm_decode(cfg, params, tokens, impl, MOE_FORCED,
                             MOE_GREEDY, time_step=False)
        dec[key]["step_ms"] = dec[key]["forced_s"] * 1e3 / MOE_FORCED
        by_path[f"moe_decode_{key}"] = dec[key]["launches"]
        log(f"  decode {key}: {MOE_FORCED} teacher-forced steps "
            f"{dec[key]['step_ms']:.3f} ms a step, {MOE_GREEDY} greedy "
            f"{dec[key]['greedy_s'] * 1e3 / MOE_GREEDY:.3f} ms a step (host "
            f"clock, synchronized at both ends); launches "
            f"{dec[key]['launches']}")
    moe_launches(by_path, "moe_decode", "flash_decode",
                 (MOE_FORCED + MOE_GREEDY) * cfg.n_layers)
    stats[f"decode logits 0-{MOE_FORCED - 1}"] = logit_stats(
        dec["kernels"]["forced"], dec["plain"]["forced"])
    for what, st in stats.items():
        hold_stats(st, f"{what}, kernels vs plain", "kernels vs plain",
                   fails)
    for key in dec:
        if not torch.isfinite(dec[key]["forced"]).all():
            raise AssertionError(f"non-finite {key} decode logits")
    same = (dec["kernels"]["ids"] == dec["plain"]["ids"]).float()
    log(f"  greedy ids equal kernels vs plain (a reading): "
        f"{same.mean(1).tolist()} of {MOE_GREEDY + 1} choices a row")
    published = logit_stats(dec["kernels"]["forced"],
                            runs["kernels"]["early"])
    log(f"  decode vs prefill at the published capacity factor (a reading, "
        f"not held: decode groups are the batch at capacity "
        f"{moe.capacity(LM_BATCH, m)}, prefill groups {gs} tokens at "
        f"{moe.capacity(gs, m)}): "
        f"{fmt_stats(published)}")
    del runs
    log(f"phase 8a for {MOE_ARCH}: one decode step captured in a CUDA "
        f"graph (pos a 0-d int32 on the card), replayed at {CAPTURE_STEPS} "
        f"consecutive positions against the eager step")
    moe_captured(cfg, params, dec, by_path, fails)
    moe_nodrop(cfg, params, tokens, by_path, fails)
    gc.collect()
    torch.cuda.empty_cache()
    moe_int8(cfg, params, tokens, by_path, fails)
    log("  K6 / K7 at its shapes and the prefill / decode split:")
    rows = moe_attention_rows(device, by_path)
    moe_split(cfg, params, tokens, rows[0]["ms_device"],
              {k: {"step_ms": d["step_ms"]} for k, d in dec.items()})
    log(f"  peak device memory over phase 8d "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if fails:
        raise AssertionError("phase 8d outside its limits: "
                             + "; ".join(fails))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 10 ----

def step_parts(cfg, batch: dict, device, impl: str = "xla",
               ref_grads=None) -> tuple:
    """One train step's parts from the seeded initial parameters (drawn on
    the host, so every device starts from the same numbers): (loss, the
    gradient leaves, the parameter leaves after AdamW on these gradients,
    and on ``ref_grads`` when given), on the host."""
    params = param.map_tree(lambda t: t.to(device), train_lib.init_params(
        cfg, TRAIN_SEED, torch.device("cpu")))
    loss, grads = value_and_grad(train_lib.loss_fn(cfg, impl), params,
                                 train_lib.to_device(batch, device))

    def after(g):
        new, _, _ = opt_lib.update(TRAIN_OPT, g, opt_lib.init(params),
                                   params)
        return [p.cpu() for p in param.sorted_leaves(new)]

    fed = None if ref_grads is None else after(param.replace_leaves(
        params, [g.to(device) for g in ref_grads]))
    return (loss.cpu(), [g.cpu() for g in param.sorted_leaves(grads)],
            after(grads), fed)


def leaf_err(got: list, want: list) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def hold_step(got: tuple, want: tuple, what: str, tol: dict) -> None:
    """Loss, gradients and, when ``got`` holds them, the parameters after
    AdamW on ``want``'s gradients, within ``tol``; the parameters after
    each side's own gradients are a reading: AdamW's first step moves a
    parameter by lr x g / (|g| + eps), which turns the rounding of a
    gradient element near eps (after the clip scale) into a difference of
    up to lr."""
    errs = {"loss": abs(float(got[0]) - float(want[0])) / abs(
        float(want[0])), "grads": leaf_err(got[1], want[1])}
    if got[3] is not None:
        errs["params"] = leaf_err(got[3], want[2])
    log(f"  {what}: loss {float(got[0]):.6f} vs {float(want[0]):.6f}; "
        + ", ".join(f"{k} {v:.3e} (<= {tol[k]:g})" for k, v in errs.items())
        + f"; parameters after each side's own gradients (a reading) "
        f"{leaf_err(got[2], want[2]):.3e}")
    bad = [k for k, v in errs.items() if not v <= tol[k]]
    if bad:
        raise AssertionError(f"{what}: {bad} outside their limits")


def train_card_vs_cpu(device) -> None:
    """Phase 10(a): the reduced detector and LM, a train step on the card
    against the CPU, TF32 off; the LM's two attention paths against each
    other; its remat policies against remat off."""
    cpu = torch.device("cpu")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        det = train_lib.reduced_config(configs.get("tangram-detector"))
        batch = next(loader.detector_batches(det.canvas,
                                             TRAIN_REDUCED_BATCH))
        want = step_parts(det, batch, cpu)
        hold_step(step_parts(det, batch, device, ref_grads=want[1]), want,
                  f"reduced detector (canvas {det.canvas}, B="
                  f"{TRAIN_REDUCED_BATCH}), card vs CPU", TRAIN_TOL)
        lm = train_lib.reduced_config(configs.get(TRAIN_LM_ARCH))
        b, s = TRAIN_LM_SHAPE
        batch = next(loader.lm_batches(lm.vocab, b, s, seed=TRAIN_SEED))
        card = {}
        for impl in ("xla", "chunked"):
            want = step_parts(lm, batch, cpu, impl)
            card[impl] = step_parts(lm, batch, device, impl,
                                    ref_grads=want[1])
            hold_step(card[impl], want,
                      f"reduced LM ({b} x {s}, {impl!r}), card vs CPU",
                      TRAIN_TOL)
        hold_step(card["chunked"][:3] + (None,), card["xla"],
                  "reduced LM on the card, 'chunked' vs 'xla'",
                  dict.fromkeys(TRAIN_TOL, TRAIN_IMPL_TOL))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    for policy in ("dots", "minimal"):
        cfg = dataclasses.replace(lm, remat=True, remat_policy=policy)
        got = remat_step(cfg, lm, batch, device)
        log(f"  reduced LM remat {policy!r}: loss {got[0]} vs {got[1]} "
            f"remat off (bit-equal required); peak "
            f"{got[2] / 1e9:.3f} GB vs {got[3] / 1e9:.3f} GB")


def remat_step(cfg, base, batch: dict, device) -> tuple:
    """(loss with ``cfg``'s remat, loss of ``base`` without, peak memory of
    each) of one step's loss and gradients on the card, from the same
    parameters and batch under deterministic algorithms; raises unless the
    losses are bit-equal."""
    params = train_lib.init_params(base, TRAIN_SEED, device)
    dev_batch = train_lib.to_device(batch, device)
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for c in (cfg, base):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                loss, grads = value_and_grad(train_lib.loss_fn(c), params,
                                             dev_batch)
                torch.cuda.synchronize()
                out.append((loss, torch.cuda.max_memory_allocated()))
                del grads
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(out[0][0], out[1][0]):
        raise AssertionError(f"remat changed the loss: {float(out[0][0])!r}"
                             f" vs {float(out[1][0])!r}")
    return float(out[0][0]), float(out[1][0]), out[0][1], out[1][1]


def step_split(loss_fn, params, opt_state, batch) -> tuple:
    """(forward, backward, optimizer) ms of one train step, CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = [p.detach().requires_grad_(True)
              for p in param.sorted_leaves(params)]
    ev[0].record()
    with torch.enable_grad():
        loss = loss_fn(param.replace_leaves(params, leaves), batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    ev[2].record()
    opt_lib.update(TRAIN_FULL_OPT, param.replace_leaves(params, grads),
                   opt_state, params)
    ev[3].record()
    ev[3].synchronize()
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def train_full_width(device) -> None:
    """Phase 10(b): the full-width detector at ``train_c32``."""
    cfg = configs.get("tangram-detector")
    (shape,) = [s for s in tangram_detector.SHAPES if s.name == TRAIN_SHAPE]
    b = shape.global_batch
    log(f"  {cfg.name} at {shape.name}: canvas {cfg.canvas}, B={b}, "
        f"{cfg.param_dtype}, remat {cfg.remat}, {cfg.n_params / 1e6:.1f}M "
        f"params")
    data = loader.detector_batches(cfg.canvas, b, seed=TRAIN_SEED)
    host, load_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        host.append(next(data))
        load_s.append(time.perf_counter() - t0)
    copy_s, batches = [], []
    for batch in host[:TRAIN_TIMED_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches.append(train_lib.to_device(batch, device))
        torch.cuda.synchronize()
        copy_s.append(time.perf_counter() - t0)
    mb = sum(v.nbytes for v in host[0].values()) / 1e6
    log(f"  loader: {statistics.median(load_s) * 1e3:.1f} ms a batch "
        f"(median of {len(load_s)}, host clock; boxes a canvas "
        f"{host[0]['valid'].sum(1).mean():.1f}); host->device copy "
        f"{statistics.median(copy_s) * 1e3:.2f} ms for {mb:.1f} MB "
        f"(pageable)")

    params = train_lib.init_params(cfg, TRAIN_SEED, device)
    opt_state = opt_lib.init(params)
    loss_fn = train_lib.loss_fn(cfg)
    step_fn = make_train_step(loss_fn, TRAIN_FULL_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(step_ms[1:])
    log(f"  device step {ms:.2f} ms (CUDA events, median of steps 1-"
        f"{len(step_ms) - 1}; first {step_ms[0]:.2f} ms): "
        f"{b / ms * 1e3:.1f} canvases/s; peak memory {peak / 1e9:.2f} GB; "
        f"losses {[round(x, 4) for x in losses]}")
    split = [step_split(loss_fn, params, opt_state, batches[0])
             for _ in range(3)]
    fwd, bwd, opt = (statistics.median(x) for x in zip(*split))
    log(f"  split (median of 3, CUDA events): forward {fwd:.2f} ms, "
        f"backward {bwd:.2f} ms, optimizer {opt:.2f} ms")
    busy = device_busy(lambda: step_fn(params, opt_state, batches[0]))
    if busy is None:
        log("  idle share: the profiler recorded no device activity; not "
            "measured")
    else:
        log(f"  a profiled step: {busy[1]} device activities, "
            f"{busy[0]:.2f} ms busy of {ms:.2f} ms: device idle share "
            f"{1 - busy[0] / ms:.1%}")
    fixed = []
    for _ in range(TRAIN_FIXED_STEPS):
        params, opt_state, metrics = step_fn(params, opt_state, batches[0])
        fixed.append(float(metrics["loss"]))
    log(f"  {TRAIN_FIXED_STEPS} steps on one batch: losses "
        f"{[round(x, 4) for x in fixed]}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: "
                             f"{fixed[0]} -> {fixed[-1]}")
    got = remat_step(dataclasses.replace(cfg, remat=True), cfg, host[0],
                     device)
    log(f"  remat on (the trunk's dots policy): loss {got[0]} vs {got[1]} "
        f"remat off, bit-equal; loss and gradients peak {got[2] / 1e9:.2f} "
        f"GB vs {got[3] / 1e9:.2f} GB")
    like = {"p": params, "o": opt_state}
    del batches, metrics
    gc.collect()
    torch.cuda.empty_cache()

    kw = dict(steps=TRAIN_STEPS, seed=TRAIN_SEED, opt_cfg=TRAIN_FULL_OPT,
              log_every=TRAIN_CKPT_EVERY, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, drill = train_lib.train(
            cfg, shape, ckpt_dir=tmp, ckpt_every=TRAIN_CKPT_EVERY,
            injector=FailureInjector([FailureEvent(TRAIN_DRILL_AT, "host",
                                                   0)]), **kw)
        drill_s = time.perf_counter() - t0
        at = TRAIN_DRILL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
        restored = ckpt_lib.restore(tmp, at, like)
        with torch.no_grad():
            again = float(loss_fn(restored["p"], train_lib.to_device(
                host[TRAIN_DRILL_AT], device)))
        del restored
    t0 = time.perf_counter()
    _, plain = train_lib.train(cfg, shape, ckpt_dir=None, **kw)
    plain_s = time.perf_counter() - t0
    log(f"  drill run ({drill_s:.1f} s, checkpoints every "
        f"{TRAIN_CKPT_EVERY}, drill at {TRAIN_DRILL_AT}): "
        f"{[round(x, 4) for x in drill]}")
    log(f"  run without it ({plain_s:.1f} s): "
        f"{[round(x, 4) for x in plain]}")
    log(f"  the step-{at} checkpoint on batch {TRAIN_DRILL_AT}: {again!r} "
        f"(the drill run's step {TRAIN_DRILL_AT}: {drill[TRAIN_DRILL_AT]!r})")
    before = max(abs(a - b) / abs(b) for a, b in zip(
        drill[:TRAIN_DRILL_AT], plain[:TRAIN_DRILL_AT]))
    log(f"  steps 0-{TRAIN_DRILL_AT - 1}, drill run vs the other: largest "
        f"relative difference {before:.3e}")
    if not before <= TRAIN_TOL["loss"]:
        raise AssertionError("the drill run left the plain run before the "
                             "drill")
    if abs(again - drill[TRAIN_DRILL_AT]) > TRAIN_TOL["loss"] * abs(again):
        raise AssertionError("the drill did not resume from the restored "
                             "checkpoint")


def train_phase(device, by_path: dict) -> None:
    """Phase 10: training, with no hand kernel launched."""
    reset_launches()
    log("  (a) card against CPU at reduced width")
    train_card_vs_cpu(device)
    log(f"  (b) full width at {TRAIN_SHAPE}")
    train_full_width(device)
    by_path["train"] = dict(LAUNCHES)
    if any(LAUNCHES.values()):
        raise AssertionError(f"training launched kernels: {LAUNCHES}")
    q = torch.randn(1, 128, 4, 64, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        attn_ops.flash_attention(q, q, q, causal=True)
    except RuntimeError as e:
        log(f"  K6 on inputs that require grad raises: {e}")
    else:
        raise AssertionError("K6 accepted inputs that require grad")
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 11 ----

def dryrun_production() -> tuple:
    """Phase 11(c): ``dryrun --all --mesh production --quick`` through the
    dry run's own job runner, every model cut to ``DRYRUN_DEPTH`` layers,
    its cells counted in worker processes (one a host CPU; each starts its
    own fake process group and touches no card's memory).  Returns (rows,
    failures, seconds); the rows also go to
    ``build/dryrun_production.json``."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    jobs = [(arch, shape.name, "production", False, "16x16", True,
             DRYRUN_DEPTH)
            for arch, shape in configs.all_cells()]
    rows, failures = dryrun.run_jobs(jobs)
    out = ROOT / "build" / "dryrun_production.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"results": rows, "failures": failures},
                              indent=1))
    return rows, failures, time.perf_counter() - t0


def chunk_heads(run: dict) -> list:
    """A data-parallel run's heads, one an invocation: its ``data``
    chunks' (obj, boxes) joined, the padded rows dropped."""
    heads, i = [], 0
    for inv in run["invocations"]:
        n = len(inv.canvases)
        parts = run["heads"][i:i + DP_DATA]
        i += DP_DATA
        heads.append(tuple(np.concatenate([p[j] for p in parts])[:n]
                           for j in range(2)))
    if i != len(run["heads"]):
        raise AssertionError(f"{len(run['heads'])} trunk calls for "
                             f"{len(run['invocations'])} invocations of "
                             f"{DP_DATA} chunks")
    return heads


def same_data_parallel(one: dict, two: dict) -> None:
    """Phase 11(a)'s check: the data=2 run serves what the data=1 run
    serves.  Bit-equal boundaries and evidence (K1/K2 run on the whole
    batch either way); the trunk runs on half batches, where cuBLAS may
    pick other tiles, so heads are reported bit-equal or held to phase
    5b's bf16 limits, and routed detections paired within them."""
    same_bounds_and_evidence(one, two, "data=2 vs data=1")
    split = chunk_heads(two)
    exact = all(np.array_equal(x, y) for ha, hb in zip(one["heads"], split)
                for x, y in zip(ha, hb))
    d_obj = max(float(np.abs(a[0] - b[0]).max())
                for a, b in zip(one["heads"], split))
    d_box = max(float(np.abs(a[1] - b[1]).max())
                for a, b in zip(one["heads"], split))
    if d_obj > SCORE_TOL or d_box > BOX_TOL:
        raise AssertionError(f"data=2 vs data=1: heads differ by obj "
                             f"{d_obj}, box {d_box} px")
    ra, rb = margin_filter(one["routed"]), margin_filter(two["routed"])
    for a, b, what in ((ra, rb, "data=1"), (rb, ra, "data=2")):
        matched, excused, bad = match_detections(a, b, SCORE_TOL, BOX_TOL)
        if bad:
            raise AssertionError(f"data=2 vs data=1: {len(bad)} {what} "
                                 f"detections unpaired: {bad[:3]}")
    n = sum(len(v) for v in ra.values())
    log(f"  data=2 vs data=1: {len(one['bounds'])} invocations, {n} routed "
        f"detections paired both ways, evidence bit-equal, heads "
        f"{'bit-equal' if exact else f'within obj {d_obj:.3g}, box {d_box:.3g} px'}")


def data_parallel_phase(device, by_path: dict) -> None:
    """Phase 11(a): the 2048x1024 trace through the full-width detector on
    the serve mesh of the card (data=1), on a data=2 mesh laid over the
    card twice, and fused on the data=2 mesh."""
    build = make_model("tangram").build(reduced=False, device=device)
    arrivals, frames, _ = make_trace(device, n_frames=24, slo=5.0)
    calibrate_head(build, arrivals, frames, device)
    one = make_serve_mesh()
    two = make_serve_mesh(devices=[device] * DP_DATA)
    log(f"  serve meshes: data={one.shape['data']} over "
        f"{list(one.devices[:, 0])}, data={two.shape['data']} over "
        f"{list(two.devices[:, 0])}")
    table = profile(build[2], build[1], CANVAS, CANVAS, device, mesh=one)
    source_fn = trace_source(arrivals, frames)
    runs = {}
    for key, mesh, fuse, kernels in (
            ("dp1_unfused", one, False, UNFUSED),
            ("dp2_unfused", two, False, UNFUSED),
            ("dp2_fused", two, True, FUSED)):
        run = serve_run("device", None, build, table, source_fn, device,
                        fuse=fuse, mesh=mesh)
        check_launches(run, kernels, key)
        by_path[key] = run["launches"]
        runs[key] = run
    one_run, two_run = runs["dp1_unfused"], runs["dp2_unfused"]
    n_inv = len(two_run["invocations"])
    if one_run["n_sharded"] != 0 or two_run["n_sharded"] != n_inv:
        raise AssertionError(f"n_sharded {one_run['n_sharded']} at data=1, "
                             f"{two_run['n_sharded']} of {n_inv} at data=2")
    if runs["dp2_fused"]["n_sharded"] != 0:
        raise AssertionError("the fused path split a batch")
    if not margin_filter(one_run["routed"]):
        raise AssertionError("data=1: no detections routed")
    same_data_parallel(one_run, two_run)
    same_bounds_and_evidence(runs["dp2_fused"], one_run,
                             "fused data=2 vs unfused data=1")
    del build, frames, arrivals, runs
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_vs_card(device, card: str) -> None:
    """Phase 11(b): the detector's serve cells planned and counted on the
    unit mesh (``api.plan_cell`` + ``dryrun.run_cell``), then the same
    step run on the card at the same shapes from weights drawn from a
    seed: FLOPs (``FlopCounterMode`` over the real run) and argument
    bytes equal; the roofline compute time beside the measured CUDA-graph
    time, the memory estimate beside the peak, the data sheet's memory
    beside the card's."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import api
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_unit_mesh
    from repro_torch.sharding import ShardingConfig
    spec = configs.arch_spec("tangram-detector")
    mesh = make_unit_mesh()
    total = torch.cuda.get_device_properties(0).total_memory
    for shape in (s for s in spec.shapes if s.name in DRYRUN_CELLS):
        terms, run_s, fits = dryrun.run_cell("tangram-detector", shape,
                                             mesh, "1x1", H100, quick=True)
        plan = api.plan_cell(spec.model, shape, mesh,
                             ShardingConfig.make().rules)
        gen = torch.Generator(device=device).manual_seed(DRYRUN_SEED)
        params = param.init_params(api.param_specs(spec.model), gen, device)
        x = torch.rand((shape.global_batch, CANVAS, CANVAS, 3),
                       generator=gen, device=device)
        plan.step_fn(params, x)
        torch.cuda.synchronize()
        # the step's own peak: what earlier phases left live is not its
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            out = plan.step_fn(params, x)
        torch.cuda.synchronize()
        flops, args = fc.get_total_flops(), hlo_analysis.local_bytes(
            (params, x))
        peak = torch.cuda.max_memory_allocated() - live + args
        if flops != terms.flops_per_device or args != terms.arg_bytes:
            raise AssertionError(
                f"{shape.name}: dry run flops {terms.flops_per_device} / "
                f"arg bytes {terms.arg_bytes}, the card's run {flops} / "
                f"{args}")
        if any(not torch.isfinite(t).all() for t in out):
            raise AssertionError(f"{shape.name}: non-finite outputs")
        ms = graph_ms(lambda: plan.step_fn(params, x), iters=5)
        log(f"  {shape.name} on {card}: flops {flops:.6e} and arg bytes "
            f"{args} equal the dry run's ({run_s:.2f}s to plan and "
            f"count); t_compute {terms.t_compute * 1e3:.4f} ms vs "
            f"CUDA-graph device time {ms:.4f} ms (roofline fraction "
            f"{terms.t_compute * 1e3 / ms:.4f}); hbm_estimate "
            f"{terms.hbm_estimate / 2**30:.3f} GiB vs the step's peak "
            f"{peak / 2**30:.3f} GiB (max_memory_allocated less the "
            f"{live / 2**30:.3f} GiB live before it, plus the arguments); "
            f"HardwareConfig.hbm_bytes {H100.hbm_bytes / 2**30:.2f} GiB vs "
            f"total_memory {total / 2**30:.2f} GiB")
        del params, x, out
        torch.cuda.empty_cache()


def mesh_phase(device, by_path: dict, card: str) -> None:
    """Phase 11: the production dry run starts in a thread (its cells in
    worker processes), (a) and (b) run meanwhile, then (c) is read."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        full = pool.submit(dryrun_production)
        log(f"phase 11a: the data-parallel canvas batch at full width: "
            f"data=1 and data={DP_DATA} (the card twice), unfused and fused")
        data_parallel_phase(device, by_path)
        log("phase 11b: the dry run against the card, tangram-detector "
            f"{' and '.join(DRYRUN_CELLS)} on the unit mesh")
        dryrun_vs_card(device, card)
        rows, failures, seconds = full.result()
    log(f"phase 11c: dryrun --all --mesh production --quick, every model "
        f"cut to {DRYRUN_DEPTH} layers: {len(rows)} cells OK, "
        f"{len(failures)} failed in {seconds:.1f}s "
        f"({len(os.sched_getaffinity(0))} worker processes; rows in "
        f"build/dryrun_production.json)")
    for f in failures:
        log(f"  FAIL: {f}")
    if failures or len(rows) != 40:
        raise AssertionError(f"dry run: {len(failures)} cells failed")


# --------------------------------------------------------------- phase 12 ----

def hillclimb_production() -> tuple:
    """Phase 12(c): the hillclimb's 23 variants and ``detector_stitch``
    on the 16 x 16 production mesh, every model cut to ``DRYRUN_DEPTH``
    layers, direct counts only (``--quick``), in worker processes (one a
    host CPU, each with its own fake process group; no card memory).
    Returns (rows, failures, seconds)."""
    from repro_torch.launch import hillclimb
    t0 = time.perf_counter()
    jobs = hillclimb.jobs_for(list(hillclimb.CELLS) + ["detector_stitch"],
                              quick=True, depth=DRYRUN_DEPTH)
    rows, failures = hillclimb.run_jobs(jobs, echo=False)
    return rows, failures, time.perf_counter() - t0


def kernel_blocks_phase(by_path: dict, out: str) -> list:
    """Phase 12(a): ``hillclimb.run_kernel_blocks`` at each of
    ``K4_GEOMETRIES``: every tile of ``K4_TILES`` bit-equal to the default
    tile and within K4's tolerance of the plain version; the rows go to
    ``out``; ``pick_tile``'s answer for each geometry."""
    from repro_torch.launch import hillclimb
    reset_launches()
    rows = []
    for model, patch, d in K4_GEOMETRIES:
        log(f"  {model}: {CANVAS}^2 canvases, patch {patch}, d {d}")
        got = hillclimb.run_kernel_blocks(CANVAS, CANVAS, patch, d)
        for r in got:
            if not (r["bit_equal_default"] and r["close"]):
                raise AssertionError(
                    f"K4 tile {r['tile']} at patch {patch}, d {d}: "
                    f"bit-equal to the default {r['bit_equal_default']}, "
                    f"max abs err {r['max_abs_err']} against plain "
                    f"(tol {hillclimb.K4_TOL})")
        rows += got
    by_path["hillclimb_kernel_blocks"] = dict(LAUNCHES)
    check_launches({"launches": LAUNCHES}, ("stitch_embed",),
                   "phase 12(a) tile search")
    hillclimb.write_rows(rows, out)
    for model, patch, d in K4_GEOMETRIES:
        log(f"  pick_tile({CANVAS}, {CANVAS}, {patch}, {d}) [{model}]: "
            f"{hillclimb.pick_tile(CANVAS, CANVAS, patch, d, out=out)}")
    return rows


def clone_cache(cache: dict) -> dict:
    return {name: {k: v.clone() for k, v in layer.items()}
            for name, layer in cache.items()}


def masked_decode_phase(lm: dict, device, by_path: dict) -> None:
    """Phase 12(b): phase 8's full-width minitron-4b (its weights back on
    the card) fills a cache with ``MASKED_PREFIX`` teacher-forced steps;
    from a copy of it, ``MASKED_STEPS`` steps through K7 with
    ``cache_update="dus"`` and from another with ``"masked"``: logits and
    caches bit-equal (K7 sees the same cache), the masked run's input
    cache untouched, K7 once a layer a step; one step's time each beside
    its byte bound."""
    cfg, params, tokens = lm["cfg"], lm["params"], lm["tokens"]
    end = MASKED_PREFIX + MASKED_STEPS
    base = transformer.init_cache(cfg, LM_BATCH, LM_SEQ, device)
    dus_cfg = dataclasses.replace(cfg, cache_update="dus")
    for pos in range(MASKED_PREFIX):
        _, base = transformer.decode_step(dus_cfg, params,
                                          tokens[:, pos:pos + 1], base, pos)
    runs = {}
    for update in ("dus", "masked"):
        ucfg = dataclasses.replace(cfg, cache_update=update)
        given = clone_cache(base)
        cache = given
        logits = []
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(MASKED_PREFIX, end):
            out, cache = transformer.decode_step(
                ucfg, params, tokens[:, pos:pos + 1], cache, pos)
            logits.append(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[f"hillclimb_decode_{update}"] = dict(LAUNCHES)
        check_launches({"launches": LAUNCHES}, ("flash_decode",),
                       f"phase 12(b) {update}")
        if LAUNCHES["flash_decode"] != MASKED_STEPS * cfg.n_layers:
            raise AssertionError(f"{update}: K7 launched "
                                 f"{LAUNCHES['flash_decode']} times, "
                                 f"expected {MASKED_STEPS * cfg.n_layers}")
        if (cache is given) != (update == "dus"):
            raise AssertionError(f"{update}: decode_step returned the "
                                 f"input cache: {cache is given}")
        if update == "masked" and not all(
                torch.equal(v, base[name][k])
                for name, layer in given.items() for k, v in layer.items()):
            raise AssertionError("the masked write changed its input cache")
        runs[update] = {"logits": torch.cat(logits, 1), "cache": cache,
                        "wall": wall, "cfg": ucfg}
    same_logits = torch.equal(runs["dus"]["logits"], runs["masked"]["logits"])
    same_cache = all(torch.equal(v, runs["masked"]["cache"][name][k])
                     for name, layer in runs["dus"]["cache"].items()
                     for k, v in layer.items())
    if not (same_logits and same_cache):
        raise AssertionError(f"masked vs dus: logits equal {same_logits}, "
                             f"caches equal {same_cache}")
    for r in runs.values():     # after the check: "dus" writes pos `end`
        def step(r=r):
            return transformer.decode_step(r["cfg"], params,
                                           tokens[:, end:end + 1],
                                           r["cache"], end)
        r["step_ms"] = time_ms(step, iters=10)
        r["device_ms"] = graph_ms(step, iters=3)
    weights = sum(t.numel() * t.element_size()
                  for name, sub in params.items() if name != "embed"
                  for t in param.leaves(sub))
    row = 2 * LM_BATCH * cfg.n_kv_heads * cfg.head_dim * 2 * cfg.n_layers
    read = row * (end + 1)                 # K7 reads the cache to pos
    blend = 2 * row * LM_SEQ               # the blend reads and writes all
    log(f"  {MASKED_STEPS} steps at pos {MASKED_PREFIX}-{end - 1} of a "
        f"{LM_SEQ} cache: logits and caches bit-equal, masked vs dus; the "
        f"masked run's input cache untouched; K7 "
        f"{MASKED_STEPS * cfg.n_layers} launches each")
    for update, extra in (("dus", 0), ("masked", blend)):
        r = runs[update]
        bound = (weights + read + extra) / H100.hbm_bw * 1e3
        log(f"  {update}: {r['wall'] * 1e3 / MASKED_STEPS:.3f} ms a step "
            f"(host clock over the run), one step at pos {end} "
            f"{r['step_ms']:.3f} ms (CUDA events), device "
            f"{r['device_ms']:.3f} ms (CUDA graph) vs byte bound "
            f"{bound:.3f} ms ({weights / 1e9:.2f} GB weights + "
            f"{read / 1e6:.1f} MB cache read"
            + (f" + {extra / 1e6:.1f} MB blend read and write" if extra
               else "") + ")")
    log(f"  the masked write's device cost a step: "
        f"{runs['masked']['device_ms'] - runs['dus']['device_ms']:.3f} ms "
        f"against the blend's byte bound {blend / H100.hbm_bw * 1e3:.3f} ms")
    del runs, base
    gc.collect()
    torch.cuda.empty_cache()


def hillclimb_phase(lm: dict, device, by_path: dict) -> None:
    """Phase 12: the hillclimb's production variants start in a thread
    (their cells in worker processes), (a) and (b) run meanwhile, then (c)
    is read; every row goes to ``build/hillclimb.json``."""
    from repro_torch.launch import hillclimb
    out = str(ROOT / "build" / "hillclimb.json")
    if os.path.exists(out):
        os.remove(out)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        full = pool.submit(hillclimb_production)
        log(f"phase 12a: the K4 tile search (hillclimb kernel_blocks), "
            f"tiles {list(fused_embed.K4_TILES)}")
        kernel_blocks_phase(by_path, out)
        log(f"phase 12b: {LM_ARCH} at full width, {MASKED_STEPS} decode "
            f"steps with the masked cache write against the in-place one")
        t0 = time.perf_counter()
        lm["params"] = param.map_tree(lambda t: t.to(device), lm["params"])
        torch.cuda.synchronize()
        log(f"  phase 8's weights back on the card in "
            f"{time.perf_counter() - t0:.1f}s")
        masked_decode_phase(lm, device, by_path)
        rows, failures, seconds = full.result()
    hillclimb.write_rows(rows, out)
    log(f"phase 12c: hillclimb, {sum(len(c['variants']) for c in hillclimb.CELLS.values())} "
        f"variants and detector_stitch on the 16x16 production mesh, every "
        f"model cut to {DRYRUN_DEPTH} layers, --quick: {len(rows)} rows, "
        f"{len(failures)} failed in {seconds:.1f}s "
        f"({len(os.sched_getaffinity(0))} worker processes; rows in "
        f"build/hillclimb.json; t_* priced on the H100 data sheet)")
    for r in rows:
        if r["cell"] == "detector_stitch":
            log(f"  detector_stitch  {r['variant']:24s} "
                f"bytes/dev={r['bytes']:.3e} args={r['arg_bytes'] / 2**20:.0f}"
                f"MiB t_mem={r['t_memory']:.3e}")
        else:
            log(f"  {r['cell']:16s} {r['variant']:28s} "
                f"t_comp={r['t_compute']:.3e} t_mem={r['t_memory']:.3e} "
                f"t_coll={r['t_collective']:.3e} [{r['bottleneck']}] "
                f"frac={r['frac']:.3f} hbm={r['hbm_gib']:.2f}GiB "
                f"fits={r['fits']}")
    for f in failures:
        log(f"  FAIL: {f}")
    want = sum(len(c["variants"]) for c in hillclimb.CELLS.values()) + 2
    if failures or len(rows) != want:
        raise AssertionError(f"hillclimb: {len(failures)} variants failed, "
                             f"{len(rows)} rows of {want}")


# --------------------------------------------------------------- phase 13 ----

#: phase 13: the port's examples, run as a user runs them
EXAMPLES = ROOT / "examples"
#: phase 13: routed scores this close to the 0.5 threshold may cross it
#: between the card and the CPU (float32 summation order), as phase 5's
EXAMPLE_MARGIN = 1e-3


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``__main__`` block does not
    run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv: list, card: str):
    """``mod.main(argv)`` with every launch count set to 0 just before and
    read just after; its stdout is echoed indented.  Returns (what main
    returns, the launches, the stdout)."""
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for line in out.getvalue().splitlines():
        log(f"    | {line}")
    ran = {k: v for k, v in launches.items() if v} or "none"
    log(f"  {mod.__name__[len('example_'):]}.py {' '.join(argv)}: "
        f"{wall:.2f}s wall, launches {ran}, card {card}")
    return result, launches, out.getvalue()


@contextlib.contextmanager
def serve_routes(routed: dict):
    """Record, frame by frame in completion order, the detections that the
    executors of ``launch/serve.main`` route."""
    make = serve_lib.make_executor

    def recording(*args, **kwargs):
        ex = make(*args, **kwargs)
        release = ex.on_complete

        def on_complete(comp):
            for fid, dets in comp.outputs[0].items():
                routed.setdefault(fid, []).extend(dets)
            release(comp)

        ex.on_complete = on_complete
        return ex

    serve_lib.make_executor = recording
    try:
        yield
    finally:
        serve_lib.make_executor = make


def served_counts(text: str) -> tuple:
    """(patches, invocations, routed detections, frames still held) of the
    serve driver's summary line."""
    m = re.search(r"served (\d+) patches in (\d+) invocations.*routed "
                  r"(\d+) detections.*\((\d+) frames still held", text)
    if not m:
        raise AssertionError(f"no summary line in: {text!r}")
    return tuple(int(x) for x in m.groups())


def same_routes(card: dict, cpu: dict) -> tuple:
    """The card's routed detections against the CPU's, both without the
    scores within ``EXAMPLE_MARGIN`` of 0.5: the same frames and counts,
    scores within 1e-4 and boxes within 1e-3 px, pair by pair.  Returns
    (detections compared, largest score and box differences)."""
    a = margin_filter(card, margin=EXAMPLE_MARGIN)
    b = margin_filter(cpu, margin=EXAMPLE_MARGIN)
    if {f: len(d) for f, d in a.items()} != {f: len(d) for f, d in b.items()}:
        raise AssertionError("serve example: routed detections differ "
                             "between the card and the CPU")
    d_score = d_box = 0.0
    for fid in a:
        for (sa, ba), (sb, bb) in zip(a[fid], b[fid]):
            d_score = max(d_score, abs(sa - sb))
            d_box = max(d_box, max(abs(x - y) for x, y in zip(ba, bb)))
    if d_score > 1e-4 or d_box > 1e-3:
        raise AssertionError(f"serve example: card vs CPU detections differ "
                             f"by {d_score} in score, {d_box} px in box")
    return sum(len(d) for d in a.values()), d_score, d_box


def quickstart_example(device, by_path: dict, card: str) -> None:
    """K5's edge stream against the plain GMM's on the card and the CPU's,
    and the report of each."""
    qs = load_example("torch_quickstart")
    (stream, res), launches, _ = run_example(qs, [], card)
    by_path["example_quickstart"] = launches
    check_launches({"launches": launches}, GMM, "quickstart example")
    if launches["gmm_update"] != qs.FRAMES:
        raise AssertionError(f"quickstart example: K5 launched "
                             f"{launches['gmm_update']} times for "
                             f"{qs.FRAMES} frames")
    reset_launches()
    plain, _ = qs.edge_stream(device, gmm_impl="torch")
    check_launches({"launches": dict(LAUNCHES)}, (), "quickstart plain GMM")
    cpu, _ = qs.edge_stream("cpu")
    if not stream or stream != plain or stream != cpu:
        raise AssertionError(f"quickstart example: K5's stream "
                             f"({len(stream)} patches) differs from the "
                             f"plain GMM's on the card ({len(plain)}) or "
                             f"the CPU's ({len(cpu)})")
    table = qs.detector_latency_model(qs.CANVAS, qs.CANVAS).build_table(16)
    with contextlib.redirect_stdout(io.StringIO()):
        want = qs.cloud_report(plain, table)
    if res.summary() != want.summary():
        raise AssertionError("quickstart example: the report differs from "
                             "the plain stream's")
    summary = res.summary()
    log(f"  quickstart: {len(stream)} patches, equal patch for patch to the "
        f"plain GMM's on the card and the CPU's; report equal "
        f"({summary['invocations']} invocations, violation rate "
        f"{summary['violation_rate']})")


def serve_example(by_path: dict, card: str) -> None:
    """The serve example on the card against the same example with
    ``--device cpu``."""
    mod = load_example("torch_serve_e2e")
    routed_card, routed_cpu = {}, {}
    with serve_routes(routed_card):
        _, launches, text = run_example(mod, [], card)
    by_path["example_serve_e2e"] = launches
    check_launches({"launches": launches}, UNFUSED + GMM, "serve example")
    with serve_routes(routed_cpu), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main(["--device", "cpu"])
    got, want = served_counts(text), served_counts(out.getvalue())
    if (got[0], got[1], got[3]) != (want[0], want[1], want[3]) or got[3]:
        raise AssertionError(f"serve example: card (patches, invocations, "
                             f"detections, held) {got} against the CPU's "
                             f"{want}")
    n, d_score, d_box = same_routes(routed_card, routed_cpu)
    log(f"  serve_e2e: card {got} and CPU {want} (patches, invocations, "
        f"detections, frames held); {n} detections off the threshold equal "
        f"(score within {d_score:.2e}, box {d_box:.2e} px); K1 "
        f"{launches['stitch']}, K2 {launches['unstitch']}, K5 "
        f"{launches['gmm_update']}")


def lm_packing_example(device, by_path: dict, card: str) -> None:
    """K6 in the packed LM's forward and in the segment-masked call against
    their plain versions on the card (float32)."""
    mod = load_example("torch_lm_sequence_packing")
    got, launches, _ = run_example(mod, [], card)
    by_path["example_lm_packing"] = launches
    check_launches({"launches": launches}, ("flash_attention",),
                   "LM packing example")
    if launches["flash_attention"] != mod.CFG.n_layers + 1:
        raise AssertionError(f"LM packing example: K6 launched "
                             f"{launches['flash_attention']} times, want "
                             f"{mod.CFG.n_layers} layers + 1")
    seg = got["segment_ids"]
    h, out = mod.serve_row(got["params"], got["tokens"], seg, impl="torch")
    errs = {"hidden": max_abs_err(got["hidden"], h),
            "segment-masked": max_abs_err(got["attention"], out)}
    # the example's q, k and v are all ones (every output is 1): K6 again
    # on seeded random ones, with the packed row's segment ids
    gen = torch.Generator(device=device).manual_seed(13)
    q = torch.randn((1, mod.SEQ, 4, 32), generator=gen, device=device)
    k, v = (torch.randn((1, mod.SEQ, 2, 32), generator=gen, device=device)
            for _ in range(2))
    errs["segment-masked, random q/k/v"] = max_abs_err(
        attn_ops.flash_attention(q, k, v, causal=True, segment_ids=seg),
        attn_ops.flash_attention(q, k, v, causal=True, segment_ids=seg,
                                 impl="torch"))
    tol = ATTN_TOL[torch.float32]
    if max(errs.values()) > tol:
        raise AssertionError(f"LM packing example: K6 vs plain {errs}, "
                             f"limit {tol}")
    log(f"  lm_sequence_packing: {int(seg.max())} segments in the row; "
        f"K6 vs plain, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (limit {tol})")


def train_example(by_path: dict, card: str) -> None:
    """The training example: its own assertion that training learns, and
    the drill restored once; no hand kernel."""
    mod = load_example("torch_train_detector")
    (losses, drills), launches, _ = run_example(mod, [], card)
    by_path["example_train"] = launches
    check_launches({"launches": launches}, (), "train example")
    if drills != 1:
        raise AssertionError(f"train example: {drills} drills restored")
    k = max(len(losses) // 10, 1)
    log(f"  train_detector: {len(losses)} steps, loss first-{k} mean "
        f"{sum(losses[:k]) / k:.4f} -> last-{k} mean "
        f"{sum(losses[-k:]) / k:.4f}, the drill restored once")


def examples_phase(device, by_path: dict, card: str) -> None:
    quickstart_example(device, by_path, card)
    serve_example(by_path, card)
    lm_packing_example(device, by_path, card)
    train_example(by_path, card)


# ------------------------------------------------------------------ main ----

def serve_phases(build, table, arrivals, frames, device):
    """Phases 4 and 5 on one trace; returns the sync kernel, sync plain and
    async kernel runs."""
    source_fn = trace_source(arrivals, frames)
    kern = serve_run("device", None, build, table, source_fn, device)
    check_launches(kern, UNFUSED, "unfused kernels")
    if not margin_filter(kern["routed"]):
        raise AssertionError("no detections routed: nothing to compare")
    plain = serve_run("device", "torch", build, table, source_fn, device)
    check_launches(plain, (), "unfused plain")
    same_result(kern, plain, "kernels vs plain")
    async_run = serve_run("async_device", None, build, table, source_fn,
                          device)
    check_launches(async_run, UNFUSED, "unfused async")
    same_result(kern, async_run, "async vs sync")
    return kern, plain, async_run


def fused_phases(build, table, arrivals, frames, device, unfused: dict):
    """Phase 5b on one trace: the fused path, kernels sync, plain sync and
    kernels async, against each other and the unfused kernel run."""
    runs = {}
    source_fn = trace_source(arrivals, frames)
    for key, name, impl in (("sync", "device", None),
                            ("plain", "device", "torch"),
                            ("async", "async_device", None)):
        run = serve_run(name, impl, build, table, source_fn, device,
                        fuse=True)
        check_launches(run, () if impl else FUSED, f"fused {key}")
        same_bounds_and_evidence(run, unfused, f"fused {key} vs unfused")
        runs[key] = run
    if not margin_filter(runs["sync"]["routed"]):
        raise AssertionError("fused: no detections routed")
    compare_fused(runs["sync"], runs["plain"], "fused kernels vs plain")
    same_result(runs["sync"], runs["async"], "fused async vs sync")
    log(f"  fused vs unfused (kernel runs, not gated): "
        f"{fused_agreement(runs['sync'], unfused):.4f} of fused detections "
        f"paired, {fused_agreement(unfused, runs['sync']):.4f} of unfused")
    return runs


def main() -> None:
    card = card_info()
    device = torch.device("cuda")
    log("phase 2: build")
    build_kernels()
    log("phase 3: K1/K2 vs plain versions (bit-exact)")
    worst = check_kernels(device)
    check_k1_edges(device)
    log("phase 3b: K4/K3 vs plain versions")
    worst_fused = check_fused_kernels(device)
    log(f"phase 3c: K5 vs its plain version (bit-equal), {CAM_W}x{CAM_H} "
        f"and ragged sizes")
    worst_gmm, scene_frames, scene_state = check_gmm(device)

    log("phase 4/5/5b: the 2048x1024 trace through K5 and the plain GMM; "
        "full-width tangram serve, unfused and fused, sync (kernels, "
        "plain) and async executors")
    t0 = time.perf_counter()
    build = make_model("tangram").build(reduced=False, device=device)
    cfg = build[0]
    log(f"  built {cfg.name}: canvas {cfg.canvas}, patch {cfg.patch}, "
        f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"d_ff {cfg.d_ff}, {cfg.param_dtype} ({cfg.n_params / 1e6:.1f}M "
        f"params) in {time.perf_counter() - t0:.1f}s")
    edge = make_trace(device, n_frames=24, slo=5.0)
    edge_plain = make_trace(device, n_frames=24, slo=5.0, gmm_impl="torch")
    same_trace(edge, edge_plain, "2048x1024 trace, K5 vs plain GMM")
    by_path = {"edge_trace_kernels": edge[2],
               "edge_trace_plain": edge_plain[2]}
    check_launches({"launches": edge[2]}, GMM, "edge trace kernels")
    check_launches({"launches": edge_plain[2]}, (), "edge trace plain")
    if edge[2]["gmm_update"] != 24:
        raise AssertionError(f"edge trace: K5 launched "
                             f"{edge[2]['gmm_update']} times for 24 frames")
    arrivals, frames, _ = edge
    del edge_plain
    calibrate_head(build, arrivals, frames, device)
    table = profile(build[2], build[1], CANVAS, CANVAS, device)
    log("  latency table: " + str({k: (round(v[0], 5), round(v[1], 5))
                                  for k, v in table.table.items()}))
    runs, fused_runs = [], []
    for slo in (5.0, 0.5):
        # the same trace under a tighter SLO fires more, smaller batches
        trace = [dataclasses.replace(a, patch=dataclasses.replace(
            a.patch, slo=slo)) for a in arrivals]
        log(f"  trace at SLO {slo}s:")
        for key, run in zip(("sync", "plain", "async"),
                            serve_phases(build, table, trace, frames,
                                         device)):
            by_path[f"unfused_{key}_slo{slo}"] = run["launches"]
            if key == "sync":
                runs.append(run)
        for key, run in fused_phases(build, table, trace, frames, device,
                                     runs[-1]).items():
            by_path[f"fused_{key}_slo{slo}"] = run["launches"]
            if key == "sync":
                fused_runs.append(run)

    log("phase 5c: tangram_int8 at full width against tangram; served "
        "unfused and fused, kernels and plain, sync and async")
    int8_phase(build, table, arrivals, frames, device, by_path)
    log("phase 5d: TangramScheduler over a fused device executor, the "
        "trace at SLO 1.0, on the profiled table and on an online table "
        "seeded with it")
    static = scheduler_phase(build, table, arrivals, frames, device, by_path)
    online = scheduler_phase(build, table, arrivals, frames, device, by_path,
                             online=True)
    log(f"  phase 5d violation rate at SLO 1.0 s (a reading, not a gate): "
        f"static table {static:.4f}, online table {online:.4f}")
    log("phase 5e: Tangram, Clipper, ELF and MArk in simulation on a table "
        "measured on the card")
    sim_table = simulation_phase(build, device)

    log(f"phase 4c: a {EDGE_FRAMES}-frame {CAM_W}x{CAM_H} recording through "
        f"make_source('file') and the fused full-width serve")
    with tempfile.TemporaryDirectory() as tmp:
        path = record_4k(scene_frames, tmp)
        del scene_frames
        file_runs, file_frames = file_phase(build, table, path, device)
        for key, run in file_runs.items():
            by_path[f"file4k_fused_{key}"] = run["launches"]
        file_kern = file_runs["kernels"]
        del file_runs
        edge_split(path, device)
        serve_cli(path)

    log(f"phase 5f: vit_s16, efficientnet_b7 and tangram at full width, "
        f"routed by SLO class {MODEL_MAP}: sync (kernels, plain; unfused, "
        f"fused), then a two-worker model-placement pool with online "
        f"latency tables")
    models = models_phase(build, device, by_path)
    log(f"phase 5g: fleet sharding: {SHARD_CAMERAS} 2048x1024 cameras "
        f"through {SHARDS} shards (camera_id % {SHARDS}), each shard's "
        f"executor on its own CUDA stream, unfused and fused, sequential "
        f"and parallel; then {FLEET_CAMERAS} simulated cameras through "
        f"{FLEET_SHARDS} shards")
    shards_phase(build, table, sim_table, device, by_path, card)

    # "launches": the main path (the sync kernel serves: unfused for K1/K2,
    # fused for K4/K3; the 4K file serve with kernels for K5); each path's
    # own count, read just after its run, in "launches_by_path"
    launches = {k: sum(r["launches"][k]
                       for r in (runs if k in UNFUSED else fused_runs))
                for k in UNFUSED + FUSED}
    launches["gmm_update"] = by_path["file4k_fused_kernels"]["gmm_update"]

    log("phase 6: kernel and stage times (K1-K4 at the main path's largest "
        "invocation, K5 on 4K and 2048x1024 frames)")
    plan, slots, records = main_path_plan(runs[0], frames, device)
    rows = kernel_rows(plan, slots, records, launches, worst)
    time_invocation(plan, slots, records, build)
    rows += fused_rows(plan, slots, records, build, launches, worst_fused)
    log("  the 4K recording's largest fused invocation (times only):")
    plan, slots, records = main_path_plan(file_kern, file_frames, device)
    fused_rows(plan, slots, records, build, launches, worst_fused)
    del file_kern, file_frames, plan, slots, records
    log("  K4/K3 at the registry detectors' widths, at each one's largest "
        "fused invocation of phase 5f:")
    for model in ("vit_s16", "efficientnet_b7"):
        plan, slots, records = main_path_plan(
            {"invocations": [inv for inv in models["fused"]["invocations"]
                             if inv.model == model]},
            models["frames"], device)
        paths = models["by_model_path"][model]
        model_rows = fused_rows(plan, slots, records,
                                models["builds"][model],
                                paths["models_fused_sync"], None,
                                model=model)
        for row in model_rows:
            row["launches_by_path"] = {path: counts[row["kernel"]]
                                       for path, counts in paths.items()}
        # efficientnet_b7's head grid is tangram's (patch 32): its K4 row
        rows += model_rows if model == "vit_s16" else model_rows[:1]
    del models, plan, slots, records
    rows.append(gmm_row(scene_state, device, launches["gmm_update"],
                        worst_gmm))
    del build, table, runs, fused_runs, frames, arrivals, scene_state
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7: K6 flash attention and K7 flash decode vs their plain "
        "versions")
    worst_attn = check_attention(device)
    log(f"phase 8: {LM_ARCH} at full width: prefill B={LM_BATCH} "
        f"S={LM_SEQ}, {LM_FORCED} teacher-forced and {LM_GREEDY} greedy "
        f"decode steps, kernels and plain")
    lm = lm_phase(device, by_path)
    launches["flash_attention"] = \
        by_path["lm_prefill_kernels"]["flash_attention"]
    launches["flash_decode"] = by_path["lm_decode_kernels"]["flash_decode"]
    log("  K6/K7 times (CUDA events) and the prefill / decode split:")
    attn_rows = attention_rows(device, launches, worst_attn)
    lm_split(lm, attn_rows[0]["ms_device"])
    rows += attn_rows
    log(f"phase 8a: {LM_ARCH} at full width: one decode step captured in a "
        f"CUDA graph (pos a 0-d int32 on the card), replayed at "
        f"{CAPTURE_STEPS} consecutive positions against the eager step")
    captured_phase(lm, by_path)
    log(f"phase 8b: {LM_ARCH} with int8 weights and an int8 KV cache: "
        f"prefill B={LM_BATCH} S={LM_INT8_SEQ}, {LM_INT8_STEPS} decode steps")
    lm_int8_phase(lm, device, by_path)
    # phase 12(b) decodes with these weights again: they wait in host memory
    lm["params"] = param.map_tree(lambda t: t.to("cpu"), lm["params"])
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 8c: the vision and diffusion zoo at full width (ViT-B/16, "
        "DeiT-B, ViT-S/16, EfficientNet-B7, DiT-S/2, DiT-XL/2), kernels "
        "and plain")
    rows += zoo_phase(device, by_path)
    log(f"phase 8d: {MOE_ARCH} at full width: prefill B={LM_BATCH} "
        f"S={LM_SEQ}, {MOE_FORCED} teacher-forced and {MOE_GREEDY} greedy "
        f"decode steps, kernels and plain; decode vs prefill without drops; "
        f"int8 weights")
    rows += moe_phase(device, by_path)
    log(f"phase 10: training (no hand kernel): a train step card vs CPU at "
        f"reduced width, then {TRAIN_SHAPE} at full width")
    train_phase(device, by_path)
    t11 = time.perf_counter()
    mesh_phase(device, by_path, card)
    log(f"phase 11: {time.perf_counter() - t11:.1f}s")
    t12 = time.perf_counter()
    hillclimb_phase(lm, device, by_path)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t12:.1f}s")
    log("phase 13: the port's four examples (examples/torch_*.py) on the "
        "card at their own arguments")
    t13 = time.perf_counter()
    examples_phase(device, by_path, card)
    log(f"phase 13: {time.perf_counter() - t13:.1f}s")
    for row in rows:
        if "launches_by_path" not in row:      # phase 5f's rows have theirs
            row["launches_by_path"] = {path: counts[row["name"]]
                                       for path, counts in by_path.items()}
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
