#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sonar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``sonar_tpu_torch/csrc`` (into
``build/kernels/``, one ``nvcc`` per source, all at once), then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions and the kernel build time;
2. holds kernel B1 (fused momentum step) against its plain PyTorch version
   at the main path's shape and others, in every gate combination;
3. holds kernel B2 (fused scale_noise) against its plain version in every
   dead-band branch, on a tensor of more than 2**24 elements too and on
   both sides of the sizes where its launch changes (one block, one cluster,
   one cooperative grid), checks that two runs agree bit for bit and that a
   call is one device kernel; then B1 and B2 on tensors that are not
   contiguous (one counted copy, the contiguous tensor's bits) and on
   float64 (the kernels compute in float32: a TypeError, no launch);
4. runs the main path — ``sample_sonar_euler_ancestral`` with the default
   SonarConfig and gaussian noise, 20 Karras steps (14.6 → 0.03, then 0) on
   a 1×4×64×64 latent, through the flagship ``UNetConfig()`` with random
   weights from a seed — and checks that it launched B1, B2 and B3 (the
   Philox gaussian) once per step; then runs one injected noise stream
   through the kernel path and through the plain path (composed momentum
   step, plain scale_noise), TF32 off, and compares the trajectories;
5. times both paths end to end and B1 and B2 against their plain versions
   with CUDA events;
6. runs all 2**24 arguments of kernel B3's Box-Muller radius and of its
   sine and cosine against float64, then holds B3 (Philox4x32-10
   Box-Muller) against its plain version: uniforms bit for bit, normals
   within 2e-6, bfloat16 and float16 draws equal to the float32 draw rounded
   once, on a ragged shape and on more than 2**24 elements, two calls equal,
   seeds distinct, and the moments;
7. holds kernel B4 (upscale pyramid) against its plain version on the
   64×64, 512×512, a ragged and a 263×260 ladder in five modes, base drawn
   in-kernel (same seed) and given, and on ladders that stress its tap tables
   (bicubic's clamped edges on 2- and 3-wide levels, widths that are not
   multiples of 4, a level as tall as the output, sixteen levels);
8. holds kernel B5 (downscale ladders) against its plain version on the
   highres_pyramid and pyramid_old ladders, in every mode, with and without
   a base, fields drawn in-kernel and given, each of its two kernels forced
   and as the wrapper picks, at shapes on both sides of the size where it
   changes from one to the other: the two bit-equal to each other, and to
   the plain version on given fields;
9. runs the pyramid path — the sampler of phase 4 with
   ``SonarConfig(noise_type="pyramid")`` — and checks its launches (B3 once
   per small level and step, B4 once per step), then highres_pyramid and
   pyramid_old at 5 steps (B5 once per step); checks that one seed gives the
   same noise on the CPU (plain versions) and on the card (kernels) for
   gaussian and the three pyramids; and compares the pyramid path with the
   same sampler fed the plain versions' draws, TF32 off;
10. times the pyramid path, pyramid noise throughput, and B3, B4 and B5
   against their plain versions and the composed paths (B4's device time
   at 1×4×64×64 and 4×4×512×512 beside the composed path's; B3's at
   1×4×2304×2048 beside ``torch.randn``'s; B5's two kernels at 1×4×64×64,
   1×4×128×128 and 4×4×512×512 on both ladders beside their bounds);
11. holds kernel B6 (the k smallest toroidal distances of Voronoi noise)
   against its plain version: four distances, k in {1, 2, 4, 8}, N = 37,
   256 and 4,096 points (across its shared-memory chunks), the path's
   shape and ragged ones, axis weights and scale 8; then every tile height
   and point split, k = N = 8, 13 and 100 points, strided grid vectors;
12. runs the Voronoi path — the sampler of phase 4 with
   ``SonarConfig(noise_type="voronoi_mix")`` — and checks its launches (B6
   three times a step, once per octave; B3 four times a step and three
   times at set-up), reproducibility, and the trajectory against the
   sampler fed the plain versions' draws, TF32 off; then ``voronoi_fuzz``
   and a ``custom_noise`` NoiseChain of a VoronoiGenerator at 5 steps; and
   one seed's noise on the CPU (plain versions) and the card for all three;
13. holds B1 and B2 on bfloat16 and float16 latents against their plain
   versions (B2 at its launches' size limits too) and runs the bf16 headline (stub denoiser, 20 steps) through
   B1, B2 and B3, against ``use_fused=False``;
14. times the Voronoi path against the gaussian headline (with the launches
   and device time of one run of each), B6 against its plain version at
   the path's shape and at bench.py's Voronoi shape for k in {1, 2, 4, 8},
   f1 through B6 against the per-axis path, and Voronoi noise throughput;
15. runs the config-3a path: ``sample_sonar_dpmpp_sde`` with momentum 0.95
   and scheduled time-brownian power noise (inside sigma 0.3 to 14.7,
   gaussian outside) through the same UNet, the headline's schedule (19
   two-stage steps of two model calls each and the ``sigma_next == 0`` tail
   of one), seed 7; checks its launches (B2 once a draw, B3 for every
   Brownian level and the gaussian fallback, B1 none: the two-stage step is
   not the fused momentum step), reproducibility, the trajectory against
   the sampler fed the plain versions' draws, TF32 off, one seed's
   ``brownian`` and scheduled power noise on the CPU and the card; then the
   sampler's default ``brownian`` noise at 5 steps (the tail included);
16. times the config-3a path against the gaussian headline in turns
   (steps/s and model calls/s: median, min and max over the runs), one run
   of it under the profiler (device time, busy share, B2's, B3's and the
   FFTs' shares), and one evaluation of the Brownian path W and one power
   noise draw (B3 launches, host and device time);
17. holds wavelet CFG (BASELINE config 3's rule: db4, level 3,
   periodization, scheduled half-cosine diff scales) on the card against the
   same call on the CPU at 1×4×128×128, TF32 off, at sigmas inside its
   window, on its edge and outside a window (the basic-CFG fallback); runs
   one guided call of a ``SonarPipeline`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (no read back from the card);
   and times one wavelet-CFG call (device kernels and µs, host µs);
18. runs config 3 through ``SonarPipeline`` on the flagship UNet
   (``sonar_dpmpp_sde``, momentum 0.95, the scheduled power noise of [15],
   wavelet CFG, the uncond denoiser fed ``x·c_in·0.97`` as bench.py does),
   20 steps: B2 and B3 launch as in [15] and wavelet CFG adds no launch of
   B1–B6; the card against the CPU on one injected noise stream at 4 steps,
   TF32 off; a bf16 latent against the float32 run;
19. runs config 3 at its own size: the SDXL-class UNet of bench.py:552-558
   (320 channels, mult (1, 2, 4, 4), 2 res blocks, attention at levels 2
   and 3, 8 heads; random weights from seed 0, float32) on a 1×4×128×128
   latent, 30 Karras steps 14.6 → 0.03 and a final 0, against plain
   ``sonar_euler`` (momentum 1.0) with basic CFG at scale 7: ms per model
   call (steps × stages, as bench.py reckons it) over interleaved runs,
   the overhead of config 3 per model call, the device-busy share of one
   profiled run, the peak device memory and the launches of B2 and B3;
20. holds FreeU-Extreme's three spectral operators (dense K, FFT, the
   rank-decomposed pair) equal to each other on the card and the card's FFT
   to the CPU's, on the stage-1 slice of the SDXL-class UNet (960 channels
   at 16×16, 32×32 and 64×64) with the global TF32 switches on and off,
   times each (device time and time by events), counts the activations a
   config-4 cond forward filters, and runs one patched forward of the
   SDXL-class UNet under ``torch.cuda.set_sync_debug_mode("error")``;
21. runs BASELINE configs 4 (``sonar_euler``, momentum 0.95, per-band and
   per-orientation wavelet CFG, FreeU on the cond UNet) and 2
   (``sonar_euler_ancestral``, momentum 0.95, a NoiseChain of ``perlin``
   and ``onef_pinkish``, CFG 7) on phase 19's SDXL-class UNet at
   1×4×128×128, 30 steps: launches, reproducibility, ms per model call over
   runs interleaved with ``sonar_euler`` + basic CFG, each config's
   overhead per model call, the busy share of one profiled run and the peak
   memory; then both on the flagship UNet at 1×4×64×64 on the card against
   the CPU on one injected noise stream, TF32 off;
22. runs config 5's video noise (16-frame time-brownian power noise, frames
   folded into channels, 1×4×16×128×128): launches, normalization, Mpix/s
   over 20 draws, and one seed on the CPU and the card;
23. runs the sampler registry, every one of its 31 names (the three ``_gpu``
   aliases once, 28 functions), on the flagship at 1×4×64×64, 10 steps (20
   until PR 10, cut to leave [25] room),
   seed 7: a first run counting model calls (a wrapper that takes the
   host sigma) and launches, with ``torch.cuda.set_sync_debug_mode("error")``
   on from its first model call (dpm_adaptive, which reads its error back
   once an attempt, exempt); steps/s as the median of 3 runs by CUDA
   events; the busy share of one profiled run; one
   ``sampler_config_override`` of dpmpp_2s_ancestral with pyramid noise
   (B4); and every function on the card against the CPU at 4 steps on one
   injected numpy stream, TF32 off (dpm_adaptive with a tight controller:
   the same attempts and accepted steps on both);
24. runs ``dpmpp_2m_sde_gpu`` (Brownian noise) and ``dpmpp_2s_ancestral``
   through ``SonarPipeline`` with basic CFG 7 on phase 19's SDXL-class UNet
   at 1×4×128×128, 30 steps: guided calls, launches, peak memory, ms per
   model call over 2 runs each interleaved with ``sonar_euler`` + basic CFG,
   the overhead against it, and the busy share of one profiled run;
25. runs the combinator algebra: config 5's Voronoi z-walk cell
   (tools/bench_configs.py:143-157: ``PerDimNoise`` over the frames of a
   ``CustomNoiseParametersNoise`` Voronoi generator, 32 points, f1, z up
   0.35 a frame) at 1×4×16×128×128, seed 3, sigma 1.0 → 0.9: launches (B6
   and B3 once a frame), the z walk, Mpix/s over 4 runs of 5 draws, device
   time, CPU vs card on two draws; then three combinator trees under
   ``sample_sonar_euler_ancestral`` on the flagship at 1×4×64×64, 20 steps,
   seed 7 (A: a composite of a repeated pyramid and a modulated channel
   noise, all six kernels; B: pattern break, shuffle, quantile filter,
   advanced range remap, an ops program, a blend filter of ripple-filtered,
   wavelet-filtered and ``wavelet`` noise; C: a blend of a guided random
   pick of resized, per-dim and latent-op-filtered noise with gaussian):
   launches, reproducibility, 20 steps under
   ``torch.cuda.set_sync_debug_mode("error")``, steps/s as the median of 3
   runs by events in turns with the gaussian headline, busy share, and
   card vs CPU at 4 steps, TF32 off (tree B without its outer
   ``PatternBreakNoise``, whose hash of the sixth decimal turns ulps into
   unrelated values, and ``pattern_break`` alone on one input);
26. runs the rest of the noise zoo and the dual-tree transform: (a)
   ``sample_sonar_euler_ancestral`` on the flagship at 1×4×64×64, 20 steps,
   seed 7, with ``distro`` noise (its default normal and its gamma, whose
   rounds of rejection are drawn at once), ``collatz`` noise and
   ``ScatternetFilteredNoise`` over gaussian (DTCWT, order 1): launches,
   reproducibility, 20 steps under ``torch.cuda.set_sync_debug_mode("error")``,
   steps/s as the median of 3 runs by events in turns with the headline,
   busy share, card vs CPU at 4 steps, TF32 off (gamma by the share of
   elements past the tolerance: an accept decision may differ where B3's
   normals differ by an ulp); (b) each of the 26 distributions drawn once on
   the card and the CPU on one seed (transforms within 1e-5; the rejection
   samplers and geometric's floor by the share past 1e-5, under 1e-3) and
   2^20 times on the card, held by a KS test against ``scipy.stats`` or by
   their moments; (c) ``dtcwt2d``/``idtcwt2d`` at 1×4×128×128, level 3, for
   every biort and qshift name: reconstruction within 1e-5 with the TF32
   switches on and off, card vs CPU 1e-5, and scatternet's four layers card
   vs CPU; (d) config 3 with ``use_dtcwt`` on phase 19's SDXL-class UNet
   (30 steps, 2 runs a side in turns with [19]'s config 3 and euler + basic
   CFG; 3 before [27] needed the room): ms per model call, the overhead,
   one WCFG call's device time and kernels, busy share, peak memory, one guided call under the sync check,
   and the flagship card vs CPU at 4 steps on one injected stream, TF32 off;
27. runs the node/workflow API: ComfyUI prompt graphs (widget values only,
   no ``yaml_parameters``) through ``port_workflow`` and
   ``pipeline_from_workflow``, and says whether PyYAML imports here. (a)
   BASELINE config 2 as a four-node graph (perlin 0.6 chained with
   onef_pinkish 0.4 into ``SamplerSonarEulerA`` at momentum 0.95, a host
   ``SamplerCustom`` at cfg 7, seed 7) on [19]'s SDXL-class module at
   1×4×128×128, 30 steps: the host time of ``port_workflow``, launches and
   output equal to [21]'s config 2, peak memory within 0.1 GiB of it, ms per
   model call in turns with it (2 runs a side), one guided call under the
   sync check; (b) a pyramid (variant "pyramid") chained with Voronoi into
   ``SamplerSonarEulerA``, wavelet CFG at its widget defaults and a
   ``KarrasScheduler``, on the flagship at 1×4×64×64, 20 steps: launches
   (B1, B2, B3, B4, B6), reproducibility, the run after its first model call
   under the sync check, steps/s and busy share in turns with the headline,
   card vs CPU at 4 steps with the noise live, TF32 off, ``StepTimer``'s
   p50/p90 and one ``trace``; (c) all 60 node names built on the card from
   their schema defaults: each noise drawn once at 1×4×64×64 (finite,
   normalized), each sampler node run 2 steps on the flagship (B5 launches
   where the sweep draws highres_pyramid);
28. runs the model tier: (a) DiT-S/2 (bench.py:174: hidden 384, depth 12,
   6 heads, patch 2; random weights from seed 0) through
   ``make_dit_denoiser`` and ``sample_sonar_euler_ancestral`` at the
   headline's latent, schedule and seed: launches (B1, B2, B3 20 each),
   reproducibility, the run after its first model call under the sync
   check, the kernel path against the plain path on one injected stream
   and the card against the CPU at 4 steps, TF32 off; steps/s as the median
   of 3 runs in turns with the headline, the busy share of one profiled
   run, peak memory, ``dit_forward_flops`` and the MFU against the H100's
   bf16 peak; a bf16 DiT; (b) the Switch-MoE DiT at that width (4 experts):
   one forward card vs CPU, each block on the card's input, the share of
   routing decisions that differ and the rest within 1e-4, aux >= 1, and
   the steps/s of one 20-step run; (c) 10 training steps at batch 16 (lr
   2e-3, a fixed batch and step seed) at float32 with remat False, "full"
   and "dots" and with bf16 compute: the loss falls below 0.9 of its first
   value, the first step's gradients equal across remat within 1e-6 of
   the largest, bf16's master weights float32 and its first loss within
   5 % of float32's, B3 twice a step, the second step under the sync
   check, steps/s by events and peak memory; 3 steps of the flow objective
   served 4 steps with ``prediction="flow"`` and ``ancestral_mode="rf"``;
   (d) a checkpoint of the float32 run after step 5: restored bit-equal
   into a fresh module and optimizer, step 6 within 1e-6 of the
   uninterrupted one, a partial restore of the params; (e) one training
   step of the flagship UNet card vs CPU on injected draws, TF32 off (loss
   1e-5, gradients 1e-4 of each tensor's largest);
29. runs the parallel tier's serving path, TF32 off, against the unsharded
   runs on the card (1e-5 relative to max(1, |unsharded|) for trajectories,
   to max |unsharded| for DiT outputs): (a) in a 1-rank NCCL world made in
   this process, every sharded entry with each mesh axis of size 1: the
   flagship ``sample_sonar_euler_ancestral`` on a 2×4×64×64 ``DTensor``
   latent split on dp (20 steps, seed 7; B2 as its three split launches
   and B3 at a shard's indices; from its first model call under
   ``torch.cuda.set_sync_debug_mode("error")``, which the collectives lift
   for their span), the pyramid path at 5 steps (B4 with a plane slice),
   DiT-S/2 under tp, under dp × pp with 2 microbatches, its Switch-MoE
   under ep (the forwards under the sync check); then B2 split, B3 with a
   shard (aligned, and starting inside a Philox group) and B4 with a plane
   slice against their plain versions on the card (B2 1e-5, B3 uniforms
   bitwise and normals 2e-6, B4 1e-5) and against the unsharded kernel
   draw's slice, with each new entry's device time at one rank's
   1×4×64×64 beside its bound; (b) a 2-rank gloo world of two processes
   on the one card (``parallel.run_world``; NCCL takes one rank a card):
   the flagship sampler and the pyramid path on dp=2 (each rank's draws its
   slice of the unsharded draw), DiT-S/2 under tp=2, pp=2 with 2
   microbatches and dp=2 × pp=1, the MoE under ep=2 (eps and aux), each
   rank's launches and the collectives' time a step (two processes
   time-slice the card: not a speed); prints ``{"parallel": ...}``;
30. runs the parallel tier's training half, TF32 off, against the unsharded
   training steps on the card (the flagship UNet and DiT-S/2, global batch
   8×4×64×64, Adam 2e-3, step seed 5): (a) in a 1-rank NCCL world, every
   axis of size 1, the UNet's tp and FSDP layouts (``shard_unet_params``)
   and DiT-S/2 under tp and under pp with 2 microbatches: one step's loss
   (1e-5 relative), gradients (1e-4 of each leaf's largest) and weights
   (within Adam's first-step bound), B3 twice a step and no other kernel, a
   second step under ``torch.cuda.set_sync_debug_mode("error")``; (b) in a
   2-rank gloo world on the one card, the UNet at dp=2, tp=2 and FSDP over
   dp=2 and DiT-S/2 through pp=2 with 2 microbatches, each held so against
   (a)'s unsharded step, with each rank's bytes of parameters and Adam state
   and the collectives a step (count, ms between synchronisations; not a
   speed), and each rank's B3 draws against its slice of the unsharded
   draw; (c) the unsharded state a step in, saved and restored onto the
   FSDP layout in (b)'s world: every block bit-equal to its slice, the
   resumed step's loss and gradients against the resumed unsharded step,
   its update Adam's on the gathered gradients bit for bit; prints
   ``{"parallel_train": ...}``;
31. runs every sampler and every noise type on a sharded latent, TF32 off,
   against the unsharded runs on the card (1e-5 relative to max(1,
   |unsharded|)): (a) in a 1-rank NCCL world, all 31 registry names on a
   dp=1 shard of the flagship's 1×4×64×64 at 3 steps (each from its first
   model call under ``set_sync_debug_mode("error")``, dpm_adaptive's one
   host read an attempt exempt; no ``dist.all_reduce`` call, the groups
   having one rank) and all 38 noise names, two draws each (a third under
   the sync check: the shard adds no host read to a name); B5 with
   ``planes=`` (both kernels) against its plain version and bit-equal to
   the unsharded kernel draw's planes, with its device time at one rank's
   1×4×64×64 and 4×4×512×512; (b) in [29] (b)'s 2-rank gloo world
   (``par31``), on 2×4×64×64 split on dp at 5 steps: dpmpp_2s_ancestral
   with pyramid noise, uni_pc, dpm_adaptive (the ranks' model calls
   equal), sonar_dpmpp_sde on Brownian noise and the guided flagship path
   (wavelet CFG + FreeU-Extreme + a latent-op CFG guiding sonar_euler),
   every noise name's block, and config 5's video noise on
   1×4×16×128×128 with its frames on sp=2, each rank's launches and
   collectives a step; prints ``{"sharded_all": ...}``;
32. holds kernel B7 (the attention core, ``csrc/attention.cu``) against its
   plain version at the main path's shapes (SD v1's UNet levels 0–2 and
   middle with TF32 off, DiT-XL/2's layer and FLUX.1-dev's joint attention
   with TF32 on, FLUX.1-dev's also off) and prints one line a shape: the
   tile the wrapper chose (``wgmma``, ``mma`` or ``ffma``, read from
   ``fused_attention.wgmma_launches``), the kernel's device time beside its
   bound, max(4·b·heads·n²·d
   operations at 67 TFLOP/s (FFMA) or 495 TFLOP/s (TF32), bytes at
   3.35 TB/s), the plain version's time and ``library_ms``, PyTorch's
   ``scaled_dot_product_attention`` on the same q, k, v (a yardstick the
   port never calls).

Every phase passes or the script exits non-zero without a result. Before
the last line it prints one JSON object listing the six kernels with their
launches on the paths (``launches_workflow``: [27] (a) and (b);
``launches_dit``: [28] (a); ``launches_train``: [28] (c)'s float32 run;
``launches_parallel``: [29]'s sharded runs, (a) and both ranks of (b);
``launches_parallel_train``: [30]'s sharded first steps, (a) and both ranks
of (b); ``launches_sharded_all``: [31]'s sharded runs and draws, also in
``launches_parallel``), a seventh row for B5 with a shard's planes
(its launches on [31]'s sharded draws, its device time at one rank's
1×4×64×64 and 4×4×512×512) and an eighth for B7 (its launches on the
paths as the six have them, ``launches`` being [4]'s, its times at SD v1's
level 0 and each of [32]'s shapes); every read of the counts holds B7's to
the attention blocks the models entered on the card since the counts were
set to 0 (``attention_entries``), and the paths' expected counts give it
as attention blocks times model calls where the path counts its calls;
their
error, their device time (``ms``), the plain version's, the least time the
card could take (``bound_ms``, from this
run's shapes: bytes at 3.35 TB/s against operations at 33.5 T/s, the
67 TFLOP/s fp32 peak counted as fused multiply-adds) and, where one PyTorch
route computes the same function, its time (``library_ms``). The last
line is ``{"ok": true, "device": {...}}``. It needs one CUDA device and no
network, and imports nothing of JAX.
"""

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

STEPS = 20
SHORT_STEPS = 5
REG_STEPS = 3  # [23]'s registry sweep (20 until PR 9, 10 until PR 15; cut for [25]'s and [31]'s room)
# [10]'s timings of the plain B3-B5 (200 calls by events and 50 profiled
# until PR 9; cut in PR 10, where a loaded host took [10] from 124 to 234 s)
PLAIN_CALLS, PLAIN_PROFILED = 20, 5
SHAPE = (1, 4, 64, 64)
B1_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 3, 67, 61)]
B2_SHAPES = [(1, 4, 64, 64), (4, 4, 128, 128), (1, 4, 67, 61), (1, 4, 2304, 2048)]
B3_SHAPES = [(1, 4, 64, 64), (1, 4, 67, 61), (1, 4, 2304, 2048)]
B3_SEEDS = [(0, 0), (7, 0), (2**40 + 3, 5)]  # (seed, stream)
PYR_HW = [(64, 64), (512, 512), (67, 61), (263, 260)]
DOWN_HW = [(64, 64), (128, 128), (67, 61)]
DOWN_BIG = (4, 4, 128, 128)  # a B5 path on the far side of DOWN_SPREAD_ELEMS
DOWN_BIG_STEPS = 3
B1_TOL = 1e-6  # relative to max(1, |plain|): elementwise, same order of operations
B2_TOL = 1e-5  # relative to max(1, |plain|): mean/std summed in another order
B3_TOL = 2e-6  # absolute on normals up to ~5.7: the kernel's vs torch's log/cos/sin ulps
PYR_TOL = 1e-5  # relative to max(1, |plain|): B4 sums in another order, B3's ulps
XDEV_TOL = 1e-5  # relative to max(1, |cpu|): one seed, CPU plain vs card kernels
TRAJ_TOL = 1e-4  # relative to max |trajectory|, TF32 off on both paths
B6_SHAPES = [(1, 4, 64, 64), (1, 3, 67, 61), (2, 2, 9, 130)]
B6_POINTS = [37, 256, 4096]
# every tile height B6 picks (4, 8, 16, 32 rows), with few points too
B6_TILE_SHAPES = [(1, 1, 8, 8), (1, 3, 128, 128), (1, 2, 256, 160), (4, 4, 128, 128)]
B6_TILE_POINTS = [8, 13, 100]
# B4 ladders beyond the generator's: (h, w), the levels below the base
PYR_EDGE = [((8, 6), [(3, 2), (2, 3), (1, 1)]),
            ((5, 7), [(5, 3), (1, 7), (2, 2)]),
            ((33, 130), [(33, 47), (12, 130), (3, 3), (1, 1)]),
            ((16, 18), [(max(1, 16 - i), max(1, 18 - 2 * i)) for i in range(1, 17)])]
HBM_BYTES_S = 3.35e12  # H100 SXM, published
INSTR_S = 33.5e12  # 67 TFLOP/s fp32, a fused multiply-add counted as two
# [32]: kernel B7's main-path shapes (label, packing, b, n, heads, d, TF32)
ATT_SHAPES = (("sd1 level 0", "unet", 1, 16384, 8, 40, False),
              ("sd1 level 1", "unet", 1, 4096, 8, 80, False),
              ("sd1 level 2", "unet", 1, 1024, 8, 160, False),
              ("sd1 middle", "unet", 1, 256, 8, 160, False),
              ("dit-xl2 layer", "dit", 8, 1024, 16, 72, True),
              ("flux1-dev joint", "unet", 1, 4608, 24, 128, True),
              # FLUX's shape on the 128-wide FFMA tile, which a TF32-off run takes
              ("flux1-dev joint FFMA", "unet", 1, 4608, 24, 128, False))
ATT_PEAK = {False: 67e12, True: 495e12}  # FFMA, TF32 tensor cores: FLOP/s, published
# |B7 - plain| over the plain version's RMS: each is ~1e-5 of it from float64
# in float32 and ~6e-3 with TF32 (its operands rounded to 10 bits)
ATT_TOL = {False: 1e-4, True: 3e-2}
SPIN_CYCLES = 100_000  # profile_run's marker kernel: ~50 µs at the H100's clock
B6_TOL = 1e-6  # minkowski only, relative to max(1, |plain|); the rest bit for bit
# bf16/fp16: one ulp of the working type against the plain version on the
# float32 upcast (relative to max(1, |plain|)); against the plain version
# run in the working type, which rounds each of its ~10 steps
LOW_TOL = {"bfloat16": (2.0**-7, 2.0**-4), "float16": (2.0**-10, 2.0**-7)}
BF16_TRAJ_TOL = 0.1  # relative to max |trajectory|: 20 steps of bf16 carries
VORONOI_BENCH = (1, 4, 128, 128)  # bench.py:852, 256 points
SDXL_SHAPE = (1, 4, 128, 128)  # bench.py:397-398
SDXL_STEPS = 30
CONFIG3_STEPS = 4  # the card-vs-CPU config-3 pipeline comparison
WCFG_TOL = 1e-5  # relative to max(1, |cpu|): float32 products and sums in another order
# FreeU's spectral operators on the stage-1 slice of the SDXL-class UNet (1,280
# channels, slice 0.75) at its three sizes; each against the FFT, relative to
# max(1, |fft|): dense K 3e-6 up to 32x32 (float32 sums of up to 1,024
# products), 1e-5 at 64x64 (4,096: read 3.99e-6 on the card), the factor pair
# 3e-5 (rank truncation at 1e-7); the card's FFT against the CPU's 1e-5 (cuFFT
# and pocketfft round differently)
FREEU_CH, FREEU_HW = 960, (16, 32, 64)
FREEU_TOL = {"dense": 3e-6, "sep": 3e-5, "fft": 1e-5}
FREEU_DENSE_TOL_64 = 1e-5
CONFIG4_PATCHES = {16: 6, 32: 5, 64: 1}  # stage-1 activations filtered per cond forward
TRAIN_STEPS, TRAIN_SEED = 10, 5  # [28] (c): DiT-S/2 steps a setting, the fixed step seed
CKPT_STEP = 5  # [28] (d): the float32 run is saved after this step
VIDEO_SHAPE = (1, 4, 16, 128, 128)  # tools/bench_configs.py:105, 16 frames
VIDEO_DRAWS = 20  # tools/bench_configs.py:108
ZWALK_DRAWS = 5  # tools/bench_configs.py:157
# [25]'s trees under sonar_euler_ancestral, 20 steps, seed 7: B1 once a step;
# A: B2 5 a draw (ModulatedNoise's reference, ChannelNoise, the modulation,
# RepeatedNoise, the composite), B3 gaussian 1 + perlin 3 + highres 1 +
# voronoi_mix 4 a draw and 3 for each of RepeatedNoise's 11 fresh pyramid
# draws (B4 11; the slot choices are host integers of the seed), B5 20,
# B6 3 a draw; B: B2 4 a draw (BlendFilterNoise's three children and its
# result), B3 7 (three gaussians, OneF, three wavelet octaves, the shuffle's
# uniforms); C: B2 2, B3 and B4 as RandomNoise picks (PerDimNoise's pyramid,
# four channels: a B4 and three B3 each)
TREE_LAUNCHES = {
    "A": {"B1": 20, "B2": 100, "B3": 216, "B4": 11, "B5": 20, "B6": 60},
    "B": {"B1": 20, "B2": 80, "B3": 140, "B4": 0, "B5": 0, "B6": 0},
    "C": {"B1": 20, "B2": 40, "B3": 252, "B4": 48, "B5": 0, "B6": 0},
}
ZWALK_Z_INCREMENT = 0.35  # tools/bench_configs.py:151
# [26]'s noises under sonar_euler_ancestral, 20 steps, seed 7: B1 and B2 once a
# step (the sampler's step and its normalized draw); B3 a draw: distro normal
# 1 (the normals), gamma 2 (its 8 rounds' normals and uniforms, drawn at once),
# collatz 10 (one seed array an iteration), scatternet 1 (its gaussian child)
ZOO_LAUNCHES = {k: {"B1": 20, "B2": 20, "B3": 20 * n, "B4": 0, "B5": 0, "B6": 0}
                for k, n in (("distro", 1), ("distro gamma", 2), ("collatz", 10),
                             ("scatternet", 1))}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def need(cond, msg: str):
    if not cond:
        fail(msg)


def rel_err(a, b):
    err = float((a.double() - b.double().to(a.device)).abs().max())
    return err, err / max(1.0, float(b.double().abs().max()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_sigmas(torch, steps=STEPS):
    ramp = torch.linspace(0, 1, steps, dtype=torch.float64)
    s = (14.6 ** (1 / 7.0) + ramp * (0.03 ** (1 / 7.0) - 14.6 ** (1 / 7.0))) ** 7.0
    return torch.cat([s, torch.zeros(1, dtype=torch.float64)]).float()


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(torch, fn) -> float:
    """ms of one call by CUDA events, with no warm-up call (for runs of a
    second and more, timed in turns after a first run)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_us(torch, fn, iters: int):
    """Mean device time per call in µs, summed and by kernel name: the GPU
    kernels ``fn`` launches, from torch.profiler (None if it saw none).

    The profiler misses some of the launches that follow its start: eight
    early in this script, thirteen and more after many profiles, and now
    and then every one of a profile (one such profile failed one run of
    this script in three while it gave up on an empty profile). So untimed
    calls run inside it first, ten of them and for 5 ms at least, and only
    the kernels that start after them count; their number must be a
    multiple of ``iters``. A profile that comes out empty or ragged is
    printed and taken again with four times the untimed calls and time
    (sixteen times from the third); every second one read so far was whole.
    Five such profiles in a row give up.
    ``device_us.launched`` is the number of kernels per call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            more = 4**min(attempt, 2)
            calls, until = 0, time.perf_counter() + 0.005 * more
            while calls < min(iters, 10) * more or time.perf_counter() < until:
                fn()
                calls += 1
            torch.cuda.synchronize()
            time.sleep(0.004)  # the device idles: the timed kernels start well after
            with record_function("device_us_timed"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        marks = [e.time_range.start for e in events if e.name == "device_us_timed"]
        t0 = min(marks) - 2000.0 if marks else math.inf  # µs: inside the idle gap
        # a range (this marker, the program's spans) shows on the device too
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.name != "device_us_timed"
                   and e.time_range.start >= t0]
        seen.append(len(kernels))
        if kernels and len(kernels) % iters == 0:
            break
        print(f"device_us: profile {attempt + 1} saw {len(kernels)} device kernels for "
              f"{iters} calls ({len(marks)} marks); taken again", flush=True)
    else:
        if any(seen):
            fail(f"device_us: the profiler saw {seen} kernels for {iters} calls")
        return None, {}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    device_us.launched = len(kernels) / iters
    return (sum(by_name.values()) / iters,
            {k: v / iters for k, v in by_name.items()})


def profile_run(torch, fn, what: str):
    """One call of ``fn`` under the profiler, device activity only (a
    seconds-long run is tens of thousands of kernels; the host's events
    would be ten times as many to collect): (device kernels, device µs by
    kernel name). Small launches fill its first 5 ms (the profiler misses
    what is launched in its first moments), then a marker, the spin kernel
    of ``torch.cuda._sleep``, then the device idles 4 ms; the run's kernels
    are those that start after the marker ends. A run's own idle gaps do not
    move that edge. Now and then the profiler misses every launch before
    the run (that once got a run of this script refused while the edge was
    the first idle gap, which no kernel then preceded): a profile in which
    the marker does not show is printed and taken again with four times the
    small launches (sixteen from the third); five such in a row fail.
    ``profile_run.attempts`` is the number of profiles the last call took.

    The kernels are read from the profiler's raw events (name, device, start
    and duration in ns): ``prof.events()`` builds an object an event, about
    0.2 ms each on the H100's host, 18 s for a 97,000-kernel SDXL-class run."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            until = time.perf_counter() + 0.005 * 4**min(attempt, 2)
            while time.perf_counter() < until:
                torch.zeros(1, device="cuda").add_(1.0)
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            time.sleep(0.004)
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == cuda)
        marks = [end for _, end, name in kernels if "spin_kernel" in name]
        if marks:
            break
        print(f"profile_run: {what}: profile {attempt + 1} saw {len(kernels)} device kernels "
              f"and not its marker; taken again", flush=True)
    else:
        fail(f"{what}: five profiles in a row missed the marker before the run")
    profile_run.attempts = attempt + 1
    kernels = [k for k in kernels if k[0] >= max(marks)]
    by_name = {}
    for start, end, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1000.0  # µs
    need(sum(by_name.values()) > 0, f"{what}: device time not measured")
    return len(kernels), by_name


def fmt_us(v):
    return "not measured" if v is None else f"{v:.2f} us"


# -- the least time the card could take -------------------------------------
#
# The larger of (bytes moved: every input read once, every output written
# once) / 3.35 TB/s and (arithmetic operations the function needs on these
# inputs) / 33.5 T/s. The published fp32 peak, 67 TFLOP/s, is 33.5 T fused
# multiply-adds a second; an add, a min or an integer multiply fills the same
# dispatch slot, so every arithmetic operation counts as one (a lower bound:
# the card has half as many int32 lanes). A sparse product counts its
# nonzeros. One Philox4x32-10 call is 10 rounds of 2 mul.lo, 2 mul.hi, 4 xor,
# 2 add = 100 operations for four values; Box-Muller is a log, a sqrt, a
# cos, a sin, four multiplies and four conversions for two normals.

PHILOX_INSTR = 25  # per 32-bit value
NORMAL_INSTR = PHILOX_INSTR + 6  # per normal
B1_INSTR, B2_INSTR = 27, 7  # per element, from the plain versions' operations


def bound(nbytes: float, instr: float) -> dict:
    tb, ti = nbytes / HBM_BYTES_S, instr / INSTR_S
    return {"bytes": nbytes, "instr": instr, "us": max(tb, ti) * 1e6,
            "by": "bytes" if tb >= ti else "operations"}


def b1_bound(n: int, itemsize: int = 4) -> dict:
    return bound(6 * itemsize * n + 40, B1_INSTR * n)  # 4 inputs, 2 outputs, the scalars


def b2_bound(n: int, itemsize: int = 4) -> dict:
    return bound(2 * itemsize * n, B2_INSTR * n)


def b2_split_bounds(n: int) -> dict:
    """B2 split's three launches on one rank's n floats: the two sums read
    the shard (and write a few doubles), the apply reads and writes it."""
    return {"scale_noise_moments": bound(4 * n + 16, n),
            "scale_noise_m2": bound(4 * n + 24, 3 * n),
            "scale_noise_apply": bound(8 * n + 24, 5 * n)}


def b3_bound(n: int, itemsize: int = 4) -> dict:
    return bound(itemsize * n, NORMAL_INSTR * n)


def b4_bound(shape, ladder, mode: str, *, gen: bool) -> dict:
    """B4 on ``ladder`` (level 0 the base): the output, the small levels,
    the tap tables and a given base; per pixel the base pair (two normals
    and their sum) when drawn in-kernel, and per level th*tw + tw fused
    multiply-adds, the discount's multiply and the add."""
    from sonar_tpu_torch.ops.resample import _resize_taps

    (b, c, h, w), bc = shape, shape[0] * shape[1]
    px = bc * h * w
    nbytes, instr = 4 * px * (1 if gen else 2), px * (2 * NORMAL_INSTR + 2 if gen else 0)
    for sh, sw in ladder[1:]:
        th = _resize_taps(sh, h, mode)[0].shape[1]
        tw = _resize_taps(sw, w, mode)[0].shape[1]
        nbytes += 4 * bc * sh * sw + 8 * (h * th + w * tw)
        instr += px * (th * tw + tw + 2)
    return bound(nbytes, instr)


def b5_bound(P, shape, sizes, coefs, mode: str, *, base: bool) -> dict:
    """B5 with fields drawn in-kernel: the output and a given base; per
    pixel and level one normal and a multiply-add, or four normals, the two
    weight pairs (10) and the 2x2 blend (9) for bilinear."""
    (b, c, h, w), px = shape, shape[0] * shape[1] * shape[2] * shape[3]
    instr = 0
    for planes, *_ in P._down_levels(sizes, coefs, h, w, mode):
        instr += px * (NORMAL_INSTR + 2 if planes == 1 else 4 * NORMAL_INSTR + 19)
    return bound(4 * px * (2 if base else 1), instr)


def b6_bound(shape, n_pts: int, k: int) -> dict:
    """B6: the points read and k floats a pixel written; per (pixel, point)
    the two adds of the separable distance and the 2k min/max of the
    insertion; per (row or column, point) a wrap and its term (~10); k
    roots a pixel at most."""
    b, c, h, w = shape
    px = b * c * h * w
    return bound(4 * (3 * b * c * n_pts + h + w + k * px),
                 px * n_pts * (2 + 2 * k) + b * c * (h + w) * n_pts * 10 + px * k)


# -- [29] (b): what each rank of the 2-rank gloo world runs ------------------------------------
PAR_SHAPE = (2, 4, 64, 64)  # the parallel path's latent: dp=2 holds 1x4x64x64 a rank
PAR_PYR_STEPS = 5  # the dp=2 pyramid run (B4 on the sharded path)
PAR_TOL = 1e-5  # relative (trajectories to max(1, |unsharded|), DiT outputs to max |unsharded|)
DIT_S2 = dict(hidden=384, depth=12, num_heads=6, patch_size=2)  # bench.py:174
PAR_SIGMA = (2.0, 5.0)  # the forwards' sigma batch


def par_inputs(torch):
    """The latent of [29] and the DiT forwards' input, from seeds (CPU)."""
    g = torch.Generator().manual_seed(29)
    return (torch.randn(PAR_SHAPE, generator=g) * 14.6,
            torch.randn(PAR_SHAPE, generator=g))


def par_world():
    """One rank of [29] (b): two ranks of a gloo world on the one card. Each
    builds the flagship UNet, DiT-S/2 and its Switch-MoE from the seeds of
    the main process, runs its part and returns numpy results."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import sonar_tpu_torch.kernels.fused as F
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.kernels.attention as AT
    from sonar_tpu_torch.kernels import hwrng as H
    from sonar_tpu_torch.models import (DiTConfig, UNetConfig, dit_apply, dit_param_shardings,
                                        dit_pp_apply, init_dit_params, init_unet_params,
                                        make_denoiser, shard_dit_params)
    from sonar_tpu_torch.noise import get_noise_item, make_noise_sampler
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, shard_latent
    from sonar_tpu_torch.samplers import sample_sonar_euler_ancestral
    from sonar_tpu_torch.samplers.momentum import SonarConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.filterwarnings("error", message=NO_AUTOGRAD)
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    kernels = {"B1": [F.fused_momentum_step],
               "B2": [F.fused_scale_noise, F.scale_noise_moments, F.scale_noise_m2,
                      F.scale_noise_apply],
               "B3": [H.philox_randn, H.philox_rand], "B4": [P.fused_pyramid],
               "B7": [AT.fused_attention]}
    entered = attention_entries()

    def counts():
        torch.cuda.synchronize()
        return checked_b7({k: sum(f.launches for f in fs) for k, fs in kernels.items()},
                          entered, f"[29] (b) rank {rank}: ")

    def zero():
        for fs in kernels.values():
            for f in fs:
                f.launches = 0
        entered[0] = 0

    out = {"rank": rank}
    x0, xd = (t.to(dev) for t in par_inputs(torch))
    sigmas = bench_sigmas(torch)
    mesh = make_mesh(axis_names=("dp",))
    xs = shard_latent(x0, mesh)
    shard = LatentShard.of(xs)
    rows = slice(shard.offset[0], shard.offset[0] + shard.local_shape[0])
    # the rank's draws against its slice of the unsharded draw (kernels both)
    runs = shard.runs(64, 64)
    full_u, full_n = (H.philox_rand(3, PAR_SHAPE, device=dev),
                      H.philox_randn(3, PAR_SHAPE, device=dev))
    loc_u = H.philox_rand(3, shard.local_shape, device=dev, shard=runs)
    loc_n = H.philox_randn(3, shard.local_shape, device=dev, shard=runs)
    plain_n = H.philox_randn_reference(3, shard.local_shape, device=dev, shard=runs)
    fn_s, st_s = make_noise_sampler(get_noise_item("gaussian"), PAR_SHAPE, device=dev, seed=5,
                                    shard=shard)
    fn_f, st_f = make_noise_sampler(get_noise_item("gaussian"), PAR_SHAPE, device=dev, seed=5)
    drawn_s, drawn_f = fn_s(st_s, 5.0, 1.0)[0], fn_f(st_f, 5.0, 1.0)[0][rows]
    out["draws"] = {
        "uniforms_bitwise": bool(torch.equal(loc_u, full_u[rows])),
        "normals_vs_slice": float((loc_n - full_n[rows]).abs().max()),
        "normals_vs_plain": float((loc_n - plain_n).abs().max()),
        "sampler_draw_rel": float((drawn_s - drawn_f).abs().max())
        / max(1.0, float(drawn_f.abs().max())),
    }
    # the flagship sampler on dp=2
    unet = init_unet_params(torch.Generator().manual_seed(0), UNetConfig(), device=dev)
    den = make_denoiser(unet)
    zero()
    t0 = time.perf_counter()
    traj = sample_sonar_euler_ancestral(den, xs, sigmas, seed=7)
    torch.cuda.synchronize()
    out["dp_s"] = time.perf_counter() - t0
    out["dp_launches"] = counts()
    out["dp_traj"] = traj.to_local().cpu().numpy()
    out["dp_placements"] = str(traj.placements)
    # the collectives' time a step: each timed between two synchronisations
    spent = {"all_reduce": [0, 0.0], "broadcast": [0, 0.0]}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][0] += 1
            spent[name][1] += time.perf_counter() - t
            return r
        return call

    with patched(dist, all_reduce=timed("all_reduce", dist.all_reduce),
                 broadcast=timed("broadcast", dist.broadcast)):
        sample_sonar_euler_ancestral(den, xs, sigmas, seed=7)
    out["collectives_per_step"] = {k: (n / STEPS, 1000.0 * t / STEPS)
                                   for k, (n, t) in spent.items()}
    zero()
    pyr = sample_sonar_euler_ancestral(den, xs, sigmas[-PAR_PYR_STEPS - 1:], seed=7,
                                       sonar_config=SonarConfig(noise_type="pyramid"))
    out["pyr_launches"] = counts()
    out["pyr_traj"] = pyr.to_local().cpu().numpy()
    kernels31 = {**kernels, "B5": [P.fused_downscale_pyramid], "B6": [V.voronoi_ksmallest]}
    out["p31"] = par31(torch, dev, unet, den, x0, kernels31)
    del unet, den
    # DiT-S/2 under tp=2, pp=2 (2 microbatches) and dp=2 x pp=1; its MoE under ep=2
    sig = torch.tensor(PAR_SIGMA, device=dev)
    dense = init_dit_params(torch.Generator().manual_seed(0), DiTConfig(**DIT_S2), device=dev)
    moe = init_dit_params(torch.Generator().manual_seed(0),
                          DiTConfig(**DIT_S2, num_experts=4), device=dev)
    with torch.no_grad():
        m = make_mesh(axis_names=("tp",))
        out["tp"] = dit_apply(shard_dit_params(dense, m, dit_param_shardings(dense, m)),
                              xd, sig).cpu().numpy()
        m = make_mesh(axis_names=("pp",))
        st = shard_dit_params(dense, m, dit_param_shardings(dense, m, tp=None, pp="pp"))
        out["pp"] = dit_pp_apply(st, xd, sig, m, microbatches=2, dp=None).cpu().numpy()
        m = make_mesh(axis_names=("dp", "pp"), mesh_shape=(2, 1))
        st = shard_dit_params(dense, m, dit_param_shardings(dense, m, tp=None, pp="pp"))
        out["dp"] = dit_pp_apply(st, shard_latent(xd, m), sig, m,
                                 microbatches=1).to_local().cpu().numpy()
        m = make_mesh(axis_names=("ep",))
        eps, aux = dit_apply(shard_dit_params(moe, m, dit_param_shardings(moe, m, tp=None)),
                             xd, sig, return_aux=True)
        out["ep"] = (eps.cpu().numpy(), float(aux))
    return out


# -- [30]: the parallel tier's training half ------------------------------------------------
TRAIN30_BATCH = (8, 4, 64, 64)  # the global batch; dp=2 holds 4x4x64x64 a rank
TRAIN30_SEED, TRAIN30_RESUME_SEED = 5, 6  # [28]'s step seed; the resumed step's
TRAIN30_LR = 2e-3
ADAM_EPS = 1e-8  # torch.optim.Adam's default, optax.adam's
# the sharded step against the unsharded one on the card, TF32 off: the loss
# relative (the gathers, partial products and the dp mean sum in another
# order); each gradient block within 1e-4 of its whole leaf's largest (the
# CPU tests' limit against JAX); each weight after the first Adam step
# within lr·|Δg|/(min(|g|, |g'|) + eps) of the unsharded one (how far
# lr·g/(|g| + eps) moves with g), plus 8 ulps of lr (each side forms the
# update in about eight float32 roundings of at most half an ulp) and one
# ulp of the weight a side
TRAIN30_LOSS_TOL, TRAIN30_GRAD_TOL = 1e-5, 1e-4
# torch's warning when a backward crosses an op with no autograd formula (a
# forward-only collective), which it then passes through unchanged: [30]
# makes it an error
NO_AUTOGRAD = ".*an autograd kernel was not registered"


def t30_batch(torch):
    return torch.randn(TRAIN30_BATCH, generator=torch.Generator().manual_seed(30))


def block_of(t, plc, mesh):
    """This rank's block of the whole tensor ``t`` under the placements
    ``plc`` (one per axis of ``mesh``), cut with ``narrow`` at the rank's
    coordinates."""
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(plc):
        if isinstance(pl, Shard):
            n = t.shape[pl.dim] // mesh.size(i)
            t = t.narrow(pl.dim, mesh.get_coordinate()[i] * n, n)
    return t


def t30_check(torch, local, whole_of, ref):
    """A sharded first step of ``local`` against the unsharded reference
    ``ref`` ({"grads", "params1"}: whole CPU tensors): ``whole_of(name, t)``
    maps a local parameter's name and a whole tensor of the reference to the
    block the rank holds. Returns the largest gradient error relative to its
    leaf's largest value, the Adam bound's worst ratio (<= 1 holds) and the
    largest weight difference in units of the learning rate."""
    import numpy as np

    grad_rel = bound_ratio = step_lr = 0.0
    for name, p in local.named_parameters():
        g_s = p.grad.detach().double().cpu().numpy()
        g_whole = whole_of(name, ref["grads"])
        g_u = g_whole.double().numpy()
        grad_rel = max(grad_rel, float(np.abs(g_s - g_u).max())
                       / max(float(ref["grads_max"][whole_of.key(name)]), 1e-30))
        want = whole_of(name, ref["params1"]).double().numpy()
        diff = np.abs(p.detach().double().cpu().numpy() - want)
        bound = (TRAIN30_LR * np.abs(g_s - g_u) / (np.minimum(np.abs(g_s), np.abs(g_u)) + ADAM_EPS)
                 + 8 * np.spacing(np.float32(TRAIN30_LR))
                 + 2 * np.spacing(np.abs(want).astype(np.float32)))
        bound_ratio = max(bound_ratio, float((diff / bound).max()))
        step_lr = max(step_lr, float(diff.max()) / TRAIN30_LR)
    return {"grad_rel": grad_rel, "adam_bound_ratio": bound_ratio, "max_dp_over_lr": step_lr}


class WholeOf:
    """``whole_of`` for :func:`t30_check`: the block of a reference tensor
    that a local parameter holds (``key`` its name in the reference)."""

    def __init__(self, mesh=None, plc=None, stage_blocks=None):
        self.mesh, self.plc, self.stage_blocks = mesh, plc, stage_blocks

    def key(self, name):
        if self.stage_blocks is None or not name.startswith("blocks."):
            return name
        parts = name.split(".")
        return ".".join(["blocks", str(self.stage_blocks + int(parts[1])), *parts[2:]])

    def __call__(self, name, tree):
        t = tree[self.key(name)]
        return t if self.plc is None else block_of(t, self.plc[name], self.mesh)


def state_bytes(model, opt) -> int:
    """Bytes of the rank's parameters and its optimizer's tensors."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    return n + sum(v.numel() * v.element_size() for s in opt.state.values() for v in s.values()
                   if hasattr(v, "numel") and v.dim() > 0)


def par_train_world(ref_path, ckpt_path):
    """One rank of [30] (b) and (c): two ranks of a gloo world on the one card.
    Each builds the flagship UNet and DiT-S/2 from the main process's seeds,
    steps its sharded layouts, checks them against the unsharded reference
    that the main process saved (``ref_path``), restores the checkpoint at
    ``ckpt_path`` onto the FSDP layout and resumes; it returns numbers."""
    import functools

    import torch
    import torch.distributed as dist

    import sonar_tpu_torch.kernels.fused as F
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.attention as AT
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.models.train as TR
    from sonar_tpu_torch.core.rng import derive_seed
    from sonar_tpu_torch.kernels import hwrng as H
    from sonar_tpu_torch.models import (DiTConfig, UNetConfig, dit_param_shardings,
                                        init_dit_params, init_train_state, init_unet_params,
                                        make_train_step, restore_checkpoint, shard_dit_params)
    from sonar_tpu_torch.parallel import (LatentShard, make_mesh, shard_latent, shard_target,
                                          shard_unet_params, unet_param_shardings)
    from sonar_tpu_torch.parallel.grad import gather
    from torch.distributed.tensor import Shard

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.filterwarnings("error", message=NO_AUTOGRAD)
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    kernels = {"B1": [F.fused_momentum_step],
               "B2": [F.fused_scale_noise, F.scale_noise_moments, F.scale_noise_m2,
                      F.scale_noise_apply],
               "B3": [H.philox_randn, H.philox_rand],
               "B4": [P.fused_pyramid, P.fused_pyramid_accumulate],
               "B5": [P.fused_downscale_pyramid, P.fused_downscale_accumulate],
               "B6": [V.voronoi_ksmallest], "B7": [AT.fused_attention]}
    entered = attention_entries()

    def counts():
        torch.cuda.synchronize()
        return checked_b7({k: sum(f.launches for f in fs) for k, fs in kernels.items()},
                          entered, f"[30] (b) rank {rank}: ")

    def zero():
        for fs in kernels.values():
            for f in fs:
                f.launches = 0
        entered[0] = 0

    spent = {"all_reduce": [0, 0.0], "broadcast": [0, 0.0]}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][0] += 1
            spent[name][1] += time.perf_counter() - t
            return r
        return call

    def sync_checked(key, step):
        """One more step under set_sync_debug_mode("error"): the collectives
        lift the check for their own span (gloo copies through the host)."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        except RuntimeError as e:
            raise RuntimeError(f"[30] (b) {key}: a step synchronised with the host: {e}") from None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return True

    def collectives(step):
        """One more step with each collective timed between two synchronisations."""
        for v in spent.values():
            v[:] = [0, 0.0]
        with patched(dist, all_reduce=timed("all_reduce", dist.all_reduce),
                     broadcast=timed("broadcast", dist.broadcast)):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        return {"step_s": wall,
                **{k: {"count": n, "ms": 1000.0 * t_} for k, (n, t_) in spent.items()}}

    ref = torch.load(ref_path, map_location="cpu", weights_only=True, mmap=True)
    batch = t30_batch(torch).to(dev)
    adam = functools.partial(torch.optim.Adam, lr=TRAIN30_LR)
    out = {"rank": rank, "launches": {k: 0 for k in kernels}}
    ucfg = UNetConfig()
    step_u = make_train_step(ucfg)
    for key, shape, fsdp in (("dp2", (2, 1), False), ("tp2", (1, 2), False),
                             ("fsdp_dp2", (2, 1), True)):
        mesh = make_mesh(axis_names=("dp", "tp"), mesh_shape=shape)
        unet = init_unet_params(torch.Generator().manual_seed(0), ucfg, device=dev)
        plc = unet_param_shardings(unet, mesh, fsdp=fsdp)
        local = shard_unet_params(unet, mesh, fsdp=fsdp)
        del unet
        opt = init_train_state(local, adam)
        xb = shard_latent(batch, mesh)
        zero()
        loss = float(step_u(local, opt, xb, TRAIN30_SEED))
        launched = counts()
        for k in kernels:
            out["launches"][k] += launched[k]
        res = {"loss": loss, "launches": launched, "state_bytes": state_bytes(local, opt),
               **t30_check(torch, local, WholeOf(mesh, plc), ref["unet"])}
        res["sync_checked"] = sync_checked(key, lambda: step_u(local, opt, xb, TRAIN30_SEED))
        res["collectives"] = collectives(lambda: step_u(local, opt, xb, TRAIN30_SEED))
        if key == "dp2":  # the rank's draws against its slice of the unsharded draw
            sh = LatentShard.of(xb)
            rows = slice(sh.offset[0], sh.offset[0] + sh.local_shape[0])
            u_s, e_s = TR.train_draws(TRAIN30_SEED, xb.to_local(), sh)
            u_f, e_f = TR.train_draws(TRAIN30_SEED, batch)
            e_p = H.philox_randn_reference(derive_seed(TRAIN30_SEED, "train", "eps"),
                                           TRAIN30_BATCH, device=dev)[rows]
            res["draws"] = {"uniforms_bitwise": bool(torch.equal(u_s, u_f[rows])),
                            "normals_vs_slice": float((e_s - e_f[rows]).abs().max()),
                            "normals_vs_plain_slice": float((e_s - e_p).abs().max())}
        out[key] = res
        del local, opt
    # DiT-S/2's gradients through pp=2 with 2 microbatches
    dcfg = DiTConfig(**DIT_S2)
    mesh = make_mesh(axis_names=("pp",))
    dit = init_dit_params(torch.Generator().manual_seed(0), dcfg, device=dev)
    local = shard_dit_params(dit, mesh, dit_param_shardings(dit, mesh, tp=None, pp="pp"))
    del dit
    opt = init_train_state(local, adam)
    step_d = make_train_step(dcfg, pp_mesh=mesh, microbatches=2)
    zero()
    loss = float(step_d(local, opt, batch, TRAIN30_SEED))
    launched = counts()
    for k in kernels:
        out["launches"][k] += launched[k]
    stage_blocks = mesh.get_local_rank("pp") * len(local.blocks)
    out["dit_pp2"] = {"loss": loss, "launches": launched, "state_bytes": state_bytes(local, opt),
                      **t30_check(torch, local, WholeOf(stage_blocks=stage_blocks), ref["dit"])}
    out["dit_pp2"]["sync_checked"] = sync_checked(
        "dit_pp2", lambda: step_d(local, opt, batch, TRAIN30_SEED))
    out["dit_pp2"]["collectives"] = collectives(lambda: step_d(local, opt, batch, TRAIN30_SEED))
    del local, opt
    # (c) the unsharded checkpoint restored onto the FSDP layout over dp=2, and resumed
    mesh = make_mesh(axis_names=("dp", "tp"), mesh_shape=(2, 1))
    unet = init_unet_params(torch.Generator().manual_seed(1), ucfg, device=dev)
    plc = unet_param_shardings(unet, mesh, fsdp=True)
    local = shard_unet_params(unet, mesh, fsdp=True)
    del unet
    order = [k for k, _ in local.named_parameters()]
    target = shard_target({k: p.detach() for k, p in local.named_parameters()}, mesh, plc)
    t_r = time.perf_counter()
    got = restore_checkpoint(ckpt_path, target={"params": target, "opt_state": {
        "state": {i: {"step": None, "exp_avg": target[k], "exp_avg_sq": target[k]}
                  for i, k in enumerate(order)}, "param_groups": None}}, partial=True)
    restore_s = time.perf_counter() - t_r
    saved = torch.load(os.path.join(ckpt_path, "state.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    bit_equal = all(torch.equal(got["params"][k].to_local().cpu(),
                                block_of(saved["params"][k], plc[k], mesh)) for k in order)
    bit_equal &= all(torch.equal(got["opt_state"]["state"][i][m].to_local().cpu(),
                                 block_of(saved["opt_state"]["state"][i][m], plc[k], mesh))
                     for i, k in enumerate(order) for m in ("exp_avg", "exp_avg_sq"))
    with torch.no_grad():
        for k, p in local.named_parameters():
            p.copy_(got["params"][k].to_local())
    opt = init_train_state(local, adam)
    opt.load_state_dict({"state": {i: {m: (v.to_local() if hasattr(v, "to_local") else v)
                                       for m, v in s_.items()}
                                   for i, s_ in got["opt_state"]["state"].items()},
                         "param_groups": got["opt_state"]["param_groups"]})
    loss_r = float(step_u(local, opt, shard_latent(batch, mesh), TRAIN30_RESUME_SEED))
    grad_rel = max(float((p.grad.cpu() - block_of(ref["resumed"]["grads"][k], plc[k], mesh))
                         .abs().max()) / max(float(ref["resumed"]["grads_max"][k]), 1e-30)
                   for k, p in local.named_parameters())
    # the update is Adam's on the whole tensors from the saved state, with the
    # ranks' gradient blocks put together: bit for bit on each block
    whole = init_unet_params(torch.Generator().manual_seed(1), ucfg, device=dev)
    w_opt = init_train_state(whole, adam)
    state = restore_checkpoint(ckpt_path, target={"params": whole.state_dict(),
                                                  "opt_state": None, "step": None})
    whole.load_state_dict(state["params"])
    w_opt.load_state_dict(state["opt_state"])
    for (k, p), (_, w) in zip(local.named_parameters(), whole.named_parameters()):
        g = p.grad
        for i, pl in enumerate(plc[k]):
            if isinstance(pl, Shard):
                g = gather(g, mesh, mesh.mesh_dim_names[i], pl.dim)
        w.grad = g.detach().clone()
    w_opt.step()
    mismatched = sum(int((p.detach() != block_of(w.detach(), plc[k], mesh)).sum())
                     for (k, p), (_, w) in zip(local.named_parameters(), whole.named_parameters()))
    out["restore"] = {"bit_equal": bool(bit_equal), "restore_s": restore_s, "loss": loss_r,
                      "grad_rel": grad_rel, "update_mismatched": mismatched,
                      "elements": sum(p.numel() for p in local.parameters())}
    return out


# -- [31]: every sampler and every noise type on a sharded latent ------------------------------
P31_STEPS = 3  # (a): each registry name on the flagship on a dp=1 shard
P31_B_STEPS = SHORT_STEPS  # (b): the dp=2 samplers and the guided path
P31_B_SAMPLERS = ("dpmpp_2s_ancestral", "uni_pc", "dpm_adaptive", "sonar_dpmpp_sde")
P31_SIGMAS = ((5.0, 1.0), (1.0, 0.5))  # two draws: the second reads the first's state
P31_VIDEO_SIGMAS = ((1.0, 0.9), (0.9, 0.8))
P31_B5_BIG = (4, 4, 512, 512)  # B5 planes= timed at one rank's 4x4x512x512 of 8x4x512x512
P31_NAMES = 38
# a noise name's draw that synchronises with the host unsharded as well
# (a device tensor made from host numbers): the shard must add no such read
P31_SYNC_MSG = "synchroniz"


class SyncFrom:
    """The denoiser ``fn``, counting its calls; with ``check`` it turns on
    ``torch.cuda.set_sync_debug_mode("error")`` at its first call (after the
    sampler's set-up), which the collectives lift for their own span."""

    def __init__(self, torch, fn, check=True):
        self.torch, self.fn, self.check, self.calls = torch, fn, check, 0

    def __call__(self, x, s, **kw):
        if self.check and not self.calls:
            self.torch.cuda.set_sync_debug_mode("error")
        self.calls += 1
        return self.fn(x, s, **kw)


def p31_checked(torch, what, run):
    """``run()`` with the sync check off again after it (a ``SyncFrom`` in
    ``run`` turns it on); a host read fails the phase."""
    try:
        out = run()
        torch.cuda.synchronize()
        return out
    except RuntimeError as e:  # raised, not fail(): in a rank it reaches run_world's caller
        raise RuntimeError(f"[31] {what}: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)


def p31_sampler_kw(nm):
    """(b)'s samplers: dpmpp_2s_ancestral on pyramid noise, the rest on their own."""
    from sonar_tpu_torch.noise import get_noise_item

    return {"noise_item": get_noise_item("pyramid")} if nm == "dpmpp_2s_ancestral" else {}


def p31_noise(torch, item, shape, dev, shard=None, sigmas=P31_SIGMAS):
    """Two draws of ``item`` for a latent of ``shape`` on the card (``shard``:
    this rank's block), and whether a third under
    ``set_sync_debug_mode("error")`` read the card back."""
    from sonar_tpu_torch.noise import make_noise_sampler

    fn, st = make_noise_sampler(item, shape, device=dev, seed=4, sigma_min=0.03,
                                sigma_max=14.6, shard=shard)
    got = []
    for s, sn in sigmas:
        n, st = fn(st, s, sn)
        got.append(n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(st, sigmas[-1][1], sigmas[-1][1] * 0.5)
        synced = False
    except RuntimeError as e:
        if P31_SYNC_MSG not in str(e):
            raise
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return got, synced


def p31_video_item():
    """Config 5's video noise (tools/bench_configs.py:129-140), as [22] draws it."""
    from sonar_tpu_torch.noise import CustomNoiseParametersNoise, PowerNoiseItem

    return CustomNoiseParametersNoise(
        noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
        frames_to_channels=True)


def p31_guided(torch, unet):
    """The JAX package's dryrun guided path (__graft_entry__.py:259-304) on
    the flagship: wavelet CFG (db4, level 2, per-band scales), FreeU-Extreme
    (backbone, stage 1, hidden mean, a power filter) and a latent-op CFG
    guiding sonar_euler, CFG 6. ``cond`` wraps the patched denoiser (a
    ``SyncFrom`` goes there)."""
    from sonar_tpu_torch.api import SonarPipeline
    from sonar_tpu_torch.api.guider import make_latent_op_cfg_function
    from sonar_tpu_torch.cfg import (DiscreteSampling, FreeUExtremeConfig, WaveletCFG,
                                     WCFGRules, make_freeu_patches)
    from sonar_tpu_torch.models import make_denoiser
    from sonar_tpu_torch.noise import PowerFilter

    ms = DiscreteSampling()
    frux = FreeUExtremeConfig(target="backbone", stage_1=True, scale=1.1, hidden_mean=True,
                              sonar_power_filter=PowerFilter(max_freq=0.3))
    patches = make_freeu_patches(model_sampling=ms, model_channels=unet.cfg.model_channels,
                                 output_config=frux)
    rules = WCFGRules.build(wave="db4", level=2, padding_mode="periodization",
                            high_precision_mode=False,
                            diff=dict(yl_scale=6.0, yh_scales=[5.0, "fill"]))
    lo_cfg = make_latent_op_cfg_function(
        operations=(lambda latent=None, **kw: latent * 1.05,), mode="denoised",
        blend_scale_mode="reverse_sampling", blend_strength=0.5, model_sampling=ms)

    def pipe(cond=lambda f: f):
        return SonarPipeline(model=cond(make_denoiser(unet, block_patches=patches)),
                             model_uncond=make_denoiser(unet), sampler="sonar_euler",
                             cfg_scale=6.0, wavelet_cfg=WaveletCFG(rules=rules),
                             latent_op_cfg=lo_cfg, model_sampling=ms, seed=11)

    return pipe


def par31(torch, dev, unet, den, x0, kernels):
    """[31] (b) in one rank of [29] (b)'s 2-rank gloo world: the dp=2
    samplers (each from its first model call under the sync check, but
    dpm_adaptive's one host read an attempt), the guided path, every noise
    name's block of the 2x4x64x64 latent and config 5's video noise with its
    frames on sp. Returns numpy blocks, launches and collectives a step."""
    import torch.distributed as dist

    from sonar_tpu_torch.api.functions import SAMPLERS
    from sonar_tpu_torch.noise import get_noise_item
    from sonar_tpu_torch.noise.presets import noise_type_names
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, shard_latent

    entered = attention_entries()

    def counts():
        torch.cuda.synchronize()
        return checked_b7({k: sum(f.launches for f in fs) for k, fs in kernels.items()},
                          entered, "[31] (b): ")

    def zero():
        for fs in kernels.values():
            for f in fs:
                f.launches = 0
        entered[0] = 0

    calls = [0]
    real = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    mesh = make_mesh(axis_names=("dp",))
    xs = shard_latent(x0, mesh)
    sh = LatentShard.of(xs)
    sig = bench_sigmas(torch, P31_B_STEPS)
    out = {"box": (sh.offset, sh.local_shape), "samplers": {}, "launches": {},
           "collectives_per_step": {}, "noise": {}, "noise_synced": []}
    for nm in P31_B_SAMPLERS:
        rec = SyncFrom(torch, den, check=nm != "dpm_adaptive")
        zero()
        calls[0] = 0
        with patched(dist, all_reduce=counted):
            res = p31_checked(torch, f"(b) {nm} on dp=2", lambda: SAMPLERS[nm](
                rec, xs, sig, seed=7, **p31_sampler_kw(nm)))
        out["launches"][nm] = counts()
        out["collectives_per_step"][nm] = calls[0] / P31_B_STEPS
        out["samplers"][nm] = (res.to_local().cpu().numpy(), str(res.placements), rec.calls)
    pipe = p31_guided(torch, unet)
    pipe()(xs, sig)  # a first call puts the DWT's filters and FreeU's tables on the card
    rec = []
    zero()
    calls[0] = 0
    with patched(dist, all_reduce=counted):
        res = p31_checked(torch, "(b) the guided path on dp=2", lambda: pipe(
            lambda f: rec.append(SyncFrom(torch, f)) or rec[-1])(xs, sig))
    out["launches"]["guided"] = counts()
    out["collectives_per_step"]["guided"] = calls[0] / P31_B_STEPS
    out["samplers"]["guided"] = (res.to_local().cpu().numpy(), str(res.placements), rec[0].calls)
    zero()
    for name in noise_type_names():
        got, synced = p31_noise(torch, get_noise_item(name), tuple(x0.shape), dev, sh)
        out["noise"][name] = [g.cpu().numpy() for g in got]
        if synced:
            out["noise_synced"].append(name)
    out["launches"]["noise"] = counts()
    vmesh = make_mesh(axis_names=("dp", "sp"), mesh_shape=(1, 2))
    vsh = LatentShard.of(shard_latent(torch.zeros(VIDEO_SHAPE, device=dev), vmesh, sp="sp"))
    zero()
    got, synced = p31_noise(torch, p31_video_item(), VIDEO_SHAPE, dev, vsh, P31_VIDEO_SIGMAS)
    out["launches"]["video"] = counts()
    out["video"] = {"box": (vsh.offset, vsh.local_shape), "draws": [g.cpu().numpy() for g in got],
                    "synced": synced}
    return out


_ENTERED = []  # attention_entries' counter, once installed


def attention_entries() -> list:
    """From the first call on, count in this process the attention blocks
    the models enter with a card tensor (UNet ``Attention.forward``, DiT
    ``Block.attention``): kernel B7's expected launches, one a block.
    Returns the one-element counter, which the caller sets to 0 beside the
    launch counts."""
    if not _ENTERED:
        import sonar_tpu_torch.models.dit as MD
        import sonar_tpu_torch.models.unet as MU

        _ENTERED.append(0)

        def counting(f):
            def call(self, x, *a, **kw):
                _ENTERED[0] += bool(x.is_cuda)
                return f(self, x, *a, **kw)
            return call

        MU.Attention.forward = counting(MU.Attention.forward)
        MD.Block.attention = counting(MD.Block.attention)
    return _ENTERED


def attention_blocks(model) -> int:
    """The attention blocks a forward of ``model`` enters."""
    import sonar_tpu_torch.models.dit as MD
    import sonar_tpu_torch.models.unet as MU

    return sum(isinstance(m, (MU.Attention, MD.Block)) for m in model.modules())


def b1_b6(counts: dict) -> dict:
    """Launch counts without B7's, which every read holds to the attention
    blocks entered (``attention_entries``)."""
    return {k: v for k, v in counts.items() if k != "B7"}


def checked_b7(counts: dict, entered: list, where: str = "") -> dict:
    need(counts["B7"] == entered[0], f"{where}B7 launched {counts['B7']} times for "
         f"{entered[0]} attention blocks entered on the card since the counts were set to 0")
    return counts


@contextlib.contextmanager
def patched(module, **attrs):
    """Swap module attributes for the block (plain versions, composed paths)."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import sonar_tpu_torch.core.normalize as N
    import sonar_tpu_torch.kernels.fused as F
    import sonar_tpu_torch.kernels.fused_pyramid as P
    import sonar_tpu_torch.kernels.voronoi as V
    import sonar_tpu_torch.noise.brownian as BR
    import sonar_tpu_torch.noise.generators as G
    import sonar_tpu_torch.noise.power as PW
    import sonar_tpu_torch.noise.voronoi as VN
    from sonar_tpu_torch.core.rng import derive_seed, seed_from
    from sonar_tpu_torch.kernels import _build
    from sonar_tpu_torch.kernels import hwrng as H
    from sonar_tpu_torch.models import UNetConfig, init_unet_params, make_denoiser
    from sonar_tpu_torch.noise import (CustomNoiseParametersNoise, NoiseChain, NoiseCtx,
                                       PowerFilter, PowerNoiseItem, ScheduledNoise,
                                       VoronoiGenerator, get_noise_item, make_noise_sampler)
    from sonar_tpu_torch.samplers import sample_sonar_dpmpp_sde, sample_sonar_euler_ancestral
    from sonar_tpu_torch.samplers.momentum import SonarConfig
    from sonar_tpu_torch.samplers.sonar import _dpmpp_sde_schedule
    import sonar_tpu_torch.kernels.attention as AT
    from sonar_tpu_torch.api import SonarPipeline
    from sonar_tpu_torch.cfg import (DiscreteSampling, FreeUExtremeConfig, WaveletCFG, WCFGRules,
                                     basic_cfg, ffilter, make_freeu_patches)
    import sonar_tpu_torch.cfg.freeu as FU

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    counters = {"B1": [F.fused_momentum_step],
                "B2": [F.fused_scale_noise, F.scale_noise_moments, F.scale_noise_m2,
                       F.scale_noise_apply],
                "B3": [H.philox_randn, H.philox_rand],
                "B4": [P.fused_pyramid, P.fused_pyramid_accumulate],
                "B5": [P.fused_downscale_pyramid, P.fused_downscale_accumulate],
                "B6": [V.voronoi_ksmallest],
                "B7": [AT.fused_attention]}
    entered = attention_entries()

    def reset_counts():
        for fns in counters.values():
            for f in fns:
                f.launches = 0
        entered[0] = 0

    def read_counts():
        torch.cuda.synchronize()
        return checked_b7({k: sum(f.launches for f in fns) for k, fns in counters.items()},
                          entered)

    def plain_versions():
        """The generators and scale_noise on their plain versions (on the card)."""
        stack = contextlib.ExitStack()
        stack.enter_context(patched(
            G, philox_randn=H.philox_randn_reference, philox_rand=H.philox_rand_reference,
            fused_pyramid=P.fused_pyramid_reference,
            fused_downscale_pyramid=P.fused_downscale_pyramid_reference))
        stack.enter_context(patched(N, fused_scale_noise=F.fused_scale_noise_reference))
        stack.enter_context(patched(VN, philox_rand=H.philox_rand_reference,
                                    voronoi_ksmallest=V.voronoi_ksmallest_reference))
        stack.enter_context(patched(BR, philox_randn=H.philox_randn_reference))
        stack.enter_context(patched(PW, philox_randn=H.philox_randn_reference))
        return stack

    def composed_path():
        """The generators with the kernel gates closed: Philox levels through
        scale_samples, the oversized levels built."""
        never = lambda *a: False  # noqa: E731
        return patched(G, fused_pyramid_supported=never, fused_downscale_supported=never)

    # -- phase 1: card, versions, build ---------------------------------------
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}")
    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"[1] kernels: {_build.library_path().relative_to(ROOT)} from "
          f"{[s for s in _build.SOURCES if s.endswith('.cu')]} "
          f"({'found built' if prebuilt else 'built'} in {build_s:.2f} s)")
    log = (_build.library_path().parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[1] ptxas: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- phase 2: B1 against its plain version --------------------------------
    print(f"[2] {time.perf_counter() - t_run:.0f} s into the run")
    b1_err = 0.0
    gates = [(h, i, w, 0.5) for h in (0.0, 1.0) for i in (0.0, 1.0) for w in (0.0, 1.0)]
    gates.append((1.0, 1.0, 1.0, 0.0))
    for shape in B1_SHAPES:
        x, den, hd, noise = (randn(shape) for _ in range(4))
        for has, inw, hw, ns in gates:
            scal = F.pack_momentum_scalars(
                sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75, hd_scale=1.05,
                md_scale=1.0, has=has, noise_scale=ns, in_window=inw,
                hist_window=hw, device=dev)
            out = F.fused_momentum_step(x, den, hd, noise, scal)
            ref = F.fused_momentum_step_reference(x, den, hd, noise, scal)
            torch.cuda.synchronize()
            for o, r, what in zip(out, ref, ("x", "hd")):
                need(o.is_cuda and o.shape == x.shape, f"B1 {what} output malformed")
                err, rel = rel_err(o, r)
                b1_err = max(b1_err, err)
                need(rel <= B1_TOL, f"B1 {shape} gates={(has, inw, hw, ns)} {what}: "
                                    f"rel err {rel:.3e} > {B1_TOL}")
    # a view that is not 16-byte aligned takes the scalar path
    flat = [randn((1 + 4 * 64 * 64,)) for _ in range(4)]
    views = [t[1:].view(SHAPE) for t in flat]
    scal = F.pack_momentum_scalars(sigma=3.0, dt=-1.0, momentum=0.9, hd_ratio=0.75,
                                   hd_scale=1.0, md_scale=1.0, has=1.0, noise_scale=0.3,
                                   device=dev)
    for o, r in zip(F.fused_momentum_step(*views, scal),
                    F.fused_momentum_step_reference(*views, scal)):
        err, rel = rel_err(o, r)
        b1_err = max(b1_err, err)
        need(rel <= B1_TOL, f"B1 unaligned: rel err {rel:.3e}")
    print(f"[2] B1 fused_momentum_step vs plain: shapes {B1_SHAPES} + unaligned, "
          f"{len(gates)} gate/noise cases each: max abs err {b1_err:.3e} "
          f"(tolerance {B1_TOL:g} x max(1,|plain|))")

    # -- phase 3: B2 against its plain version --------------------------------
    print(f"[3] {time.perf_counter() - t_run:.0f} s into the run")
    b2_err = 0.0

    # one element under, at and over each size where B2's launch changes
    b2_limit_shapes = [(cap + d,) for cap in (F.SCALE_NOISE_BLOCK_ELEMS,
                                              F.SCALE_NOISE_CLUSTER_ELEMS)
                       for d in (-1, 0, 1)]

    def b2_one_kernel(x, what):
        """The tier B2 takes for ``x`` and the device kernels one call launches."""
        tier = F.scale_noise_tier(x.numel(), x.element_size())
        need(device_us(torch, lambda: F.fused_scale_noise(x), 10)[0] is not None,
             f"B2 {what}: device time not measured")
        need(device_us.launched == 1, f"B2 {what}: tier {tier} launched "
                                      f"{device_us.launched} device kernels a call, not 1")
        return tier

    def b2_hold(shape, dt, tol):
        """The six dead-band cases on ``shape`` in ``dt``: each within ``tol`` of
        the plain version (run on the float32 upcast and rounded once, for a
        2-byte type), elementwise relative to max(1, |plain|); bit-equal
        across two runs; passed through as is where the noise is standard or
        zero. Returns the largest absolute error and the tier, after checking
        that a call is one device kernel."""
        base = randn(shape)
        std_normal = ((base.double() - base.double().mean()) / base.double().std()).float()
        cases = {
            "standard": (std_normal, 1.0),
            "shifted_mean": (base + 0.5, 1.0),
            "scaled_std": (base * 3.0, 1.0),
            "shift_and_scale": (base * 3.0 - 1.0, 1.0),
            "zeros": (torch.zeros(shape, device=dev), 1.0),
            "factor": (base * 2.0 + 0.25, 1.7),
        }
        worst = 0.0
        for case, (x, factor) in cases.items():
            x = x.to(dt)
            out = F.fused_scale_noise(x, factor)
            ref = F.fused_scale_noise_reference(x.float(), factor).to(dt)
            again = F.fused_scale_noise(x, factor)
            torch.cuda.synchronize()
            need(out.is_cuda and out.shape == x.shape and out.dtype == dt,
                 f"B2 {dt} output malformed")
            need(bool(torch.isfinite(out).all()), f"B2 {dt} {shape} {case}: non-finite output")
            err = (out.double() - ref.double()).abs()
            rel = float((err / ref.double().abs().clamp(min=1)).max())
            worst = max(worst, float(err.max()))
            need(rel <= tol, f"B2 {dt} {shape} {case}: rel err {rel:.3e} > {tol}")
            need(torch.equal(out, again), f"B2 {dt} {shape} {case}: two runs differ")
            if case in ("standard", "zeros"):
                need(torch.equal(out, x), f"B2 {dt} {shape} {case}: should pass through as is")
        return worst, b2_one_kernel(x, f"{dt} {shape}")

    for shape in B2_SHAPES + b2_limit_shapes:
        err, tier = b2_hold(shape, torch.float32, B2_TOL)
        b2_err = max(b2_err, err)
        print(f"[3] B2 fused_scale_noise {shape} ({math.prod(shape)} elements): tier {tier}, "
              f"{device_us.launched:.0f} device kernel a call; 6 branch cases agree, bitwise "
              f"equal across runs")
    # a view that is not 16-byte aligned loads by elements: same tree, same bits
    flat = randn((1 + 4 * 64 * 64,)) * 2.0 + 0.25
    need(torch.equal(F.fused_scale_noise(flat[1:], 1.7),
                     F.fused_scale_noise(flat[1:].clone(), 1.7)),
         "B2: an unaligned view and its aligned copy differ")
    print(f"[3] B2 fused_scale_noise vs plain: max abs err {b2_err:.3e} "
          f"(tolerance {B2_TOL:g} x max(1,|plain|)); unaligned view bit-equal to its copy")
    del flat
    # the views the CPU path takes, the card takes: after one counted copy
    # (the contiguous tensor's bits)
    vbase = randn((2, 4, 64, 66)) * 2.0 + 0.3
    views = {"transpose": vbase.transpose(2, 3), "slice": vbase[:, 1:3, ::2],
             "channels_last": vbase.contiguous(memory_format=torch.channels_last),
             "irfft2 + swapaxes": torch.fft.irfft2(torch.fft.rfft2(vbase, norm="ortho"),
                                                   s=vbase.shape[-2:],
                                                   norm="ortho").swapaxes(0, 1)}
    vscal = F.pack_momentum_scalars(sigma=3.0, dt=-1.0, momentum=0.9, hd_ratio=0.75,
                                    hd_scale=1.0, md_scale=1.0, has=1.0, noise_scale=0.3,
                                    device=dev)
    for what, v in views.items():
        need(not v.is_contiguous(), f"[3] {what}: the view is contiguous")
        n0, c0 = F.fused_scale_noise.launches, F.fused_scale_noise.copies
        o = F.fused_scale_noise(v, 1.3)
        need((F.fused_scale_noise.launches, F.fused_scale_noise.copies) == (n0 + 1, c0 + 1),
             f"B2 {what}: expected one launch and one copy")
        need(torch.equal(o, F.fused_scale_noise(v.contiguous(), 1.3)),
             f"B2 {what}: differs from its contiguous copy")
        _, rel = rel_err(o, F.fused_scale_noise_reference(v, 1.3))
        need(rel <= B2_TOL, f"B2 {what}: rel err {rel:.3e}")
        n0, c0 = F.fused_momentum_step.launches, F.fused_momentum_step.copies
        vc = v.contiguous()
        o1 = F.fused_momentum_step(v, vc, v, vc, vscal)
        need((F.fused_momentum_step.launches, F.fused_momentum_step.copies)
             == (n0 + 1, c0 + 2), f"B1 {what}: expected one launch and two copies")
        need(all(torch.equal(a, b) for a, b in zip(o1, F.fused_momentum_step(vc, vc, vc, vc,
                                                                             vscal))),
             f"B1 {what}: differs from its contiguous copy")
    # the kernels compute in float32: float64 on the card raises, no launch
    v64 = vbase.double()
    n0 = (F.fused_scale_noise.launches, F.fused_momentum_step.launches)
    refused = 0
    for call in (lambda: F.fused_scale_noise(v64, 0.5),
                 lambda: F.fused_momentum_step(v64, v64, v64, v64, vscal)):
        try:
            call()
        except TypeError:
            refused += 1
    need(refused == 2 and (F.fused_scale_noise.launches, F.fused_momentum_step.launches) == n0,
         "B1/B2 float64 on the card: expected TypeError and no launch")
    print(f"[3] B1/B2 on {list(views)}: one counted copy a view, then the kernel, bit-equal "
          f"to the contiguous copy; float64 on the card raises TypeError")
    del vbase, views, v64

    # -- phase 4: the main path ------------------------------------------------
    print(f"[4] {time.perf_counter() - t_run:.0f} s into the run")
    cfg = UNetConfig()
    model = init_unet_params(torch.Generator().manual_seed(0), cfg, device=dev)
    denoiser = make_denoiser(model)
    att4 = attention_blocks(model)  # B7's launches a model call
    sigmas = bench_sigmas(torch)
    x0 = (torch.randn(SHAPE, generator=torch.Generator().manual_seed(1))
          * float(sigmas[0])).to(dev)

    def headline(**kw):
        return sample_sonar_euler_ancestral(denoiser, x0, sigmas, seed=7, **kw)

    reset_counts()
    out = headline()
    launches = read_counts()
    need(out.is_cuda and out.shape == SHAPE and out.dtype == torch.float32,
         f"headline output malformed: {out.shape} {out.dtype} {out.device}")
    need(bool(torch.isfinite(out).all()), "headline output is not finite")
    std = float(out.std())
    # the random UNet's epsilon is small (its output conv is scaled by 1e-2),
    # so the latent keeps roughly its starting scale sigma_0 = 14.6
    need(1.0 < std < 100.0, f"headline output std {std} implausible")
    print(f"[4] headline: UNetConfig() {SHAPE}, {STEPS} steps, seed 7: output std "
          f"{std:.4f}, mean {float(out.mean()):.4f}; launches {launches}")
    need(launches == {"B1": STEPS, "B2": STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0,
                      "B7": att4 * STEPS},
         f"expected {STEPS} launches of B1, B2 and B3 and {att4} of B7 a step, got {launches}")
    repeat = headline()
    need(torch.equal(out, repeat), "headline is not reproducible for one seed")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[4] TF32 off for the comparison (cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False)")
    raw = [randn(SHAPE) * 1.3 + 0.2 for _ in range(STEPS)]
    kern = sample_sonar_euler_ancestral(
        denoiser, x0, sigmas, use_fused=None,
        noise_sampler=lambda i, s, sn: F.fused_scale_noise(raw[i]))
    plain = sample_sonar_euler_ancestral(
        denoiser, x0, sigmas, use_fused=False,
        noise_sampler=lambda i, s, sn: F.fused_scale_noise_reference(raw[i]))
    torch.cuda.synchronize()
    need(bool(torch.isfinite(kern).all()) and bool(torch.isfinite(plain).all()),
         "trajectory comparison: non-finite output")
    err, rel = rel_err(kern, plain)
    print(f"[4] kernel path vs plain path on one injected stream: max abs diff "
          f"{err:.3e}, max rel diff {rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"kernel and plain trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 5: timing ---------------------------------------------------------
    print(f"[5] {time.perf_counter() - t_run:.0f} s into the run")
    print(f"[5] timing on {card} with torch defaults (cudnn TF32 on, matmul TF32 off)")
    runs = {"kernel": lambda: headline(), "plain": lambda: headline(use_fused=False)}
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    ms = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[5] headline steps/s: kernel path {sps['kernel']:.2f} "
          f"(runs {[round(v, 3) for v in ms['kernel']]} ms), use_fused=False "
          f"{sps['plain']:.2f} (runs {[round(v, 3) for v in ms['plain']]} ms) [{card}]")

    x, den, hd, noise = (randn(SHAPE) for _ in range(4))
    scal = F.pack_momentum_scalars(sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75,
                                   hd_scale=1.05, md_scale=1.0, has=1.0,
                                   noise_scale=0.5, device=dev)
    draw = randn(SHAPE) * 1.3 + 0.2
    timing = {
        "B1": (cuda_ms(torch, lambda: F.fused_momentum_step(x, den, hd, noise, scal), 500),
               cuda_ms(torch, lambda: F.fused_momentum_step_reference(x, den, hd, noise,
                                                                      scal), 500)),
        "B2": (cuda_ms(torch, lambda: F.fused_scale_noise(draw), 500),
               cuda_ms(torch, lambda: F.fused_scale_noise_reference(draw), 500)),
    }
    for k, (km, pm) in timing.items():
        print(f"[5] {k} at {SHAPE}: kernel {km * 1000:.2f} us/call, plain "
              f"{pm * 1000:.2f} us/call (CUDA events over back-to-back calls, "
              f"host launch cost included) [{card}]")
    fns = {"B1": (lambda: F.fused_momentum_step(x, den, hd, noise, scal),
                  lambda: F.fused_momentum_step_reference(x, den, hd, noise, scal)),
           "B2": (lambda: F.fused_scale_noise(draw),
                  lambda: F.fused_scale_noise_reference(draw))}
    dev_timing = {}  # device µs per call at the path's shape: (kernel, plain)
    for k, (kf, pf) in fns.items():
        kd, pd = device_us(torch, kf, 50)[0], device_us(torch, pf, 50)[0]
        dev_timing[k] = (kd, pd)
        print(f"[5] {k} at {SHAPE}: device time per call (torch.profiler, summed "
              f"kernels): kernel {fmt_us(kd)}, plain {fmt_us(pd)} [{card}]")
    big = [randn((4, 4, 128, 128)) for _ in range(4)]
    b1_big = cuda_ms(torch, lambda: F.fused_momentum_step(*big, scal), 200)
    b1_big_dev = device_us(torch, lambda: F.fused_momentum_step(*big, scal), 50)[0]
    gbs = 24 * big[0].numel() / (b1_big / 1000) / 1e9
    large = randn(B2_SHAPES[-1]) * 1.3 + 0.2
    b2_big = cuda_ms(torch, lambda: F.fused_scale_noise(large), 20)
    b2_plain_big = cuda_ms(torch, lambda: F.fused_scale_noise_reference(large), 20)
    b2_big_dev = device_us(torch, lambda: F.fused_scale_noise(large), 10)[0]
    mid = big[0] * 1.3 + 0.2
    b2_mid_dev = (device_us(torch, lambda: F.fused_scale_noise(mid), 50)[0],
                  device_us(torch, lambda: F.fused_scale_noise_reference(mid), 50)[0])
    bd1, bd2 = b1_bound(big[0].numel()), b2_bound(large.numel())
    print(f"[5] B1 at (4, 4, 128, 128): {b1_big * 1000:.2f} us/call by events, "
          f"{gbs:.0f} GB/s at 24 B/element; device time {fmt_us(b1_big_dev)} (bound "
          f"{bd1['us']:.2f} us by {bd1['by']}) [{card}]")
    print(f"[5] B2 at (4, 4, 128, 128): device time kernel {fmt_us(b2_mid_dev[0])}, plain "
          f"{fmt_us(b2_mid_dev[1])} (bound {b2_bound(mid.numel())['us']:.2f} us by bytes) "
          f"[{card}]")
    print(f"[5] B2 at {B2_SHAPES[-1]}: kernel {b2_big * 1000:.1f} us/call by events, device "
          f"time {fmt_us(b2_big_dev)} "
          f"({8 * large.numel() / (b2_big_dev * 1e-6) / 1e9:.0f} GB/s at 8 B/element; bound "
          f"{bd2['us']:.2f} us by {bd2['by']}), plain {b2_plain_big * 1000:.1f} us/call "
          f"[{card}]")
    del mid
    del big, large

    # -- phase 6: B3 against its plain version --------------------------------
    print(f"[6] {time.perf_counter() - t_run:.0f} s into the run")
    # Box-Muller's two factors over every argument: a normal is r(u1) * c(u2),
    # so 2 * 2**24 values bound the error of all 2**48 products
    lib = _build.load_library()
    n_arg = 1 << 24
    probe = torch.empty((3, n_arg), device=dev)
    _build.check(lib, lib.sonar_box_muller_probe(
        probe[0].data_ptr(), probe[1].data_ptr(), probe[2].data_ptr(), 0, n_arg,
        torch.cuda.current_stream().cuda_stream), "box_muller_probe")
    torch.cuda.synchronize()
    arg = torch.arange(n_arg, device=dev, dtype=torch.float64)
    exact = torch.stack([torch.sqrt(-2.0 * torch.log((arg + 1.0) * 2.0**-24)),
                         torch.cos(arg * (2.0 * math.pi * 2.0**-24)),
                         torch.sin(arg * (2.0 * math.pi * 2.0**-24))])
    dist = (probe.double() - exact).abs()
    ulps = dist / (2.0**-23 * 2.0 ** torch.floor(torch.log2(exact.abs().clamp(min=2.0**-24))))
    worst = [float(v) for v in dist.max(dim=1).values]
    worst_ulp = [float(v) for v in ulps.max(dim=1).values]
    # |r c - r' c'| <= |r - r'| + r' max|c - c'|, at each u1
    implied = float((dist[0] + probe[0].double() * max(worst[1], worst[2])).max())
    print(f"[6] B3 Box-Muller over all {n_arg} arguments against float64: radius max abs "
          f"err {worst[0]:.3e} ({worst_ulp[0]:.2f} ulp), cosine {worst[1]:.3e} "
          f"({worst_ulp[1]:.2f} ulp of the value), sine {worst[2]:.3e} "
          f"({worst_ulp[2]:.2f} ulp of the value); largest radius "
          f"{float(probe[0].max()):.4f}; worst normal they imply {implied:.3e} (tolerance "
          f"{B3_TOL:g})")
    need(bool(torch.isfinite(probe).all()), "B3 Box-Muller: non-finite factor")
    need(implied <= B3_TOL, f"B3 Box-Muller: implied error {implied:.3e} > {B3_TOL}")
    del probe, arg, exact, dist, ulps

    b3_err = 0.0
    for shape in B3_SHAPES:
        firsts = []
        for seed, stream in B3_SEEDS:
            u = H.philox_rand(seed, shape, device=dev, stream=stream)
            ur = H.philox_rand_reference(seed, shape, device=dev, stream=stream)
            z = H.philox_randn(seed, shape, device=dev, stream=stream)
            zr = H.philox_randn_reference(seed, shape, device=dev, stream=stream)
            again = H.philox_randn(seed, shape, device=dev, stream=stream)
            torch.cuda.synchronize()
            need(z.shape == shape and z.dtype == torch.float32 and z.is_cuda,
                 "B3 output malformed")
            need(torch.equal(u, ur), f"B3 {shape} seed {seed}: uniforms not bitwise equal")
            need(bool(((u >= 0) & (u < 1)).all()), f"B3 {shape}: uniform out of [0, 1)")
            err = float((z - zr).abs().max())
            b3_err = max(b3_err, err)
            need(err <= B3_TOL, f"B3 {shape} seed {seed}: normals differ by {err:.3e}")
            need(torch.equal(z, again), f"B3 {shape} seed {seed}: two calls differ")
            # a 2-byte draw is the float32 draw rounded once, as the plain
            # version's .to(dtype): equal to it wherever the float32 values are
            for dt in (torch.bfloat16, torch.float16):
                zl = H.philox_randn(seed, shape, device=dev, stream=stream, dtype=dt)
                ul = H.philox_rand(seed, shape, device=dev, stream=stream, dtype=dt)
                need(zl.dtype == dt and zl.shape == shape, f"B3 {dt} output malformed")
                need(torch.equal(zl, z.to(dt)), f"B3 {shape} {dt}: normals are not the "
                                                f"float32 draw rounded once")
                need(torch.equal(ul, ur.to(dt)), f"B3 {shape} {dt}: uniforms differ from "
                                                 f"plain.to({dt})")
                need(bool((zl[z == zr] == zr.to(dt)[z == zr]).all()),
                     f"B3 {shape} {dt}: differs from plain.to({dt}) where float32 agrees")
            firsts.append(z)
        need(all(not torch.equal(a, b) for i, a in enumerate(firsts) for b in firsts[i + 1:]),
             f"B3 {shape}: two seeds gave equal draws")
        print(f"[6] B3 philox {shape} ({firsts[0].numel()} elements), seeds "
              f"{B3_SEEDS}: uniforms bitwise equal, normals agree, calls repeat; bfloat16 "
              f"and float16 draws are the float32 draw rounded once")
    z = firsts[0].double()
    mean, sd = float(z.mean()), float(z.std())
    kurt = float(((z - z.mean()) ** 4).mean() / z.var() ** 2)
    print(f"[6] B3 moments of {z.numel()} draws: mean {mean:.2e}, std {sd:.6f}, "
          f"kurtosis {kurt:.5f}")
    need(abs(mean) < 1e-3 and abs(sd - 1) < 1e-3 and abs(kurt - 3) < 1e-2,
         "B3 moments off")
    print(f"[6] B3 philox_randn vs plain: max abs err {b3_err:.3e} (tolerance "
          f"{B3_TOL:g} absolute)")
    del z, firsts, u, ur, zr, again, zl, ul

    # -- phase 7: B4 against its plain version --------------------------------
    print(f"[7] {time.perf_counter() - t_run:.0f} s into the run")
    b4_err = 0.0
    for hw in PYR_HW:
        sizes = G._size_ladder_pyramid(*hw, 10, 0)
        shape = (1, 4, *hw)
        disc = [0.7**i for i in range(1, len(sizes))]
        base = randn((4, *hw))
        smalls = [randn((4, sh, sw)) for sh, sw in sizes[1:]]
        for mode in P.UP_MODES:
            for what, out, ref in (
                    ("gen_base", P.fused_pyramid(11, shape, sizes, 0.7, mode, device=dev),
                     P.fused_pyramid_reference(11, shape, sizes, 0.7, mode, device=dev)),
                    ("given base", P.fused_pyramid_accumulate(base, smalls, disc, mode),
                     P.fused_pyramid_accumulate_reference(base, smalls, disc, mode))):
                torch.cuda.synchronize()
                need(bool(torch.isfinite(out).all()), f"B4 {hw} {mode}: non-finite")
                err, rel = rel_err(out, ref)
                b4_err = max(b4_err, err)
                need(rel <= PYR_TOL, f"B4 {hw} {mode} {what}: rel err {rel:.3e}")
        print(f"[7] B4 pyramid {hw} ladder {sizes}: {len(P.UP_MODES)} modes, in-kernel "
              f"and given base agree")
    for hw, below in PYR_EDGE:
        sizes = [hw, *below]
        for bc in (1, 3):
            shape = (1, bc, *hw)
            disc = [0.7**i for i in range(1, len(sizes))]
            base = randn((bc, *hw))
            smalls = [randn((bc, sh, sw)) for sh, sw in below]
            for mode in P.UP_MODES:
                for what, out, ref in (
                        ("gen_base", P.fused_pyramid(17, shape, sizes, 0.7, mode, device=dev),
                         P.fused_pyramid_reference(17, shape, sizes, 0.7, mode, device=dev)),
                        ("given base", P.fused_pyramid_accumulate(base, smalls, disc, mode),
                         P.fused_pyramid_accumulate_reference(base, smalls, disc, mode))):
                    torch.cuda.synchronize()
                    need(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                         f"B4 {hw} {mode}: malformed or non-finite")
                    err, rel = rel_err(out, ref)
                    b4_err = max(b4_err, err)
                    need(rel <= PYR_TOL, f"B4 edge {sizes} bc={bc} {mode} {what}: rel err "
                                         f"{rel:.3e}")
    print(f"[7] B4 edge ladders {[(hw, len(b)) for hw, b in PYR_EDGE]} (size, levels), 1 and "
          f"3 planes, {len(P.UP_MODES)} modes, in-kernel and given base agree")
    print(f"[7] B4 fused_pyramid vs plain: max abs err {b4_err:.3e} (tolerance "
          f"{PYR_TOL:g} x max(1,|plain|), matmul TF32 off)")

    # -- phase 8: B5 against its plain version --------------------------------
    print(f"[8] {time.perf_counter() - t_run:.0f} s into the run")
    # both kernels forced and the wrapper's pick, at the generators' shapes
    # and on both sides of the size where the pick changes
    cap = P.DOWN_SPREAD_ELEMS
    down_shapes = [(1, 4, *hw) for hw in DOWN_HW] + [
        (1, 4, 128, 192), (1, 4, 128, 193), (1, 1, 1, cap - 1), (1, 1, 1, cap + 1),
        (1, 1, 2, cap // 2 + 2), (2, 3, 33, 130), (1, 3, 5, 7), (1, 2, 3, 1)]
    need({P.downscale_variant(math.prod(sh)) for sh in down_shapes} == {1, 2}
         and P.downscale_variant(cap) == 1 and P.downscale_variant(cap + 1) == 2,
         "B5: the shapes do not cross its size limit")
    b5_err, b5_cases, skipped = 0.0, 0, []
    for shape in down_shapes:
        hw, bc = shape[2:], shape[0] * shape[1]
        hi = G._size_ladder_highres(*hw, 4, 0)
        ladders = {
            "highres_pyramid": (hi, [0.7**i for i in range(len(hi))]),
            "pyramid_old": ([(hw[0] * 2 ** (i + 1), hw[1] * 2 ** (i + 1)) for i in range(5)],
                            [(0.5**i) * 0.8**i for i in range(5)]),
        }
        base = randn(shape)
        for lname, (sizes, coefs) in ladders.items():
            gs = [randn((bc, 4, *hw)) for _ in sizes]
            for mode in P.DOWN_MODES:
                if not P.fused_downscale_supported(sizes, *hw, mode):
                    skipped.append((hw, lname, mode))
                    continue
                for b in (None, base):
                    ref = P.fused_downscale_pyramid_reference(13, shape, sizes, coefs, mode,
                                                              base=b, device=dev)
                    b3 = None if b is None else b.reshape(bc, *hw)
                    outs, gouts = [], []
                    for v in (1, 2, None):
                        with P._forced_down_variant(v):
                            outs.append(P.fused_downscale_pyramid(13, shape, sizes, coefs,
                                                                  mode, base=b, device=dev))
                            gouts.append(P.fused_downscale_accumulate(gs, hw, sizes, coefs,
                                                                      mode, base=b3))
                    gref = P.fused_downscale_accumulate_reference(gs, hw, sizes, coefs, mode,
                                                                  base=b3)
                    torch.cuda.synchronize()
                    what = f"B5 {shape} {lname} {mode} base {b is not None}"
                    need(bool(torch.isfinite(outs[0]).all()), f"{what}: non-finite")
                    need(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2]),
                         f"{what}: the two kernels draw different bits")
                    err, rel = rel_err(outs[0], ref)
                    b5_err = max(b5_err, err)
                    need(rel <= PYR_TOL, f"{what} drawn: rel err {rel:.3e}")
                    need(all(torch.equal(o, gref) for o in gouts),
                         f"{what} given fields: not bit-equal to the plain version")
                    b5_cases += 1
        print(f"[8] B5 {shape} ({math.prod(shape)} elements, the wrapper picks kernel "
              f"{P.downscale_variant(math.prod(shape))}): highres ladder {hi} and the "
              f"pyramid_old ladder agree")
    print(f"[8] B5 not run where the gate is closed (composed path): "
          f"{sorted(set((ln, m) for _, ln, m in skipped))} at {len(skipped)} shapes")
    print(f"[8] B5 fused_downscale_pyramid vs plain, {b5_cases} cases, both kernels forced "
          f"and the wrapper's pick (limit {cap} elements): the kernels bit-equal to each "
          f"other; given fields bit-equal to the plain version; drawn fields max abs err "
          f"{b5_err:.3e} (tolerance {PYR_TOL:g} x max(1,|plain|))")

    # -- phase 9: the pyramid path --------------------------------------------
    print(f"[9] {time.perf_counter() - t_run:.0f} s into the run")
    pyr_cfg = SonarConfig(noise_type="pyramid")
    ladder = G._size_ladder_pyramid(SHAPE[2], SHAPE[3], 10, 0)
    reset_counts()
    pout = headline(sonar_config=pyr_cfg)
    path_launches = read_counts()
    need(pout.is_cuda and pout.shape == SHAPE and bool(torch.isfinite(pout).all()),
         "pyramid path output malformed or not finite")
    pstd = float(pout.std())
    need(1.0 < pstd < 100.0, f"pyramid path output std {pstd} implausible")
    want = {"B1": STEPS, "B2": STEPS, "B3": STEPS * (len(ladder) - 1), "B4": STEPS, "B5": 0,
            "B6": 0, "B7": att4 * STEPS}
    print(f"[9] pyramid path: UNetConfig() {SHAPE}, {STEPS} steps, seed 7, ladder "
          f"{ladder}: output std {pstd:.4f}; launches {path_launches}")
    need(path_launches == want, f"pyramid path: expected launches {want}")
    need(torch.equal(pout, headline(sonar_config=pyr_cfg)), "pyramid path not reproducible")
    need(not torch.equal(pout, out), "pyramid path equals the gaussian headline")
    short = bench_sigmas(torch, SHORT_STEPS)
    down_launches = {}
    for nt in ("highres_pyramid", "pyramid_old"):
        reset_counts()
        o = sample_sonar_euler_ancestral(denoiser, x0, short, seed=7,
                                         sonar_config=SonarConfig(noise_type=nt))
        c = down_launches[nt] = read_counts()
        need(bool(torch.isfinite(o).all()), f"{nt} path not finite")
        print(f"[9] {nt} path: {SHORT_STEPS} steps, output std {float(o.std()):.4f}; "
              f"launches {c}")
        need(c["B5"] == SHORT_STEPS and c["B1"] == SHORT_STEPS and c["B4"] == 0
             and c["B7"] == att4 * SHORT_STEPS,
             f"{nt}: expected {SHORT_STEPS} launches of B5 and B1, got {c}")
    # the same two noises on a batch of four 128 x 128 latents: 262,144
    # elements, beyond DOWN_SPREAD_ELEMS, so this path runs B5's other kernel
    # (one thread a group) and B2's cluster tier
    need(P.downscale_variant(math.prod(DOWN_BIG)) == 2
         and P.downscale_variant(math.prod(SHAPE)) == 1,
         "B5: the two downscale paths do not sit on both sides of its size limit")
    xbig = (torch.randn(DOWN_BIG, generator=torch.Generator().manual_seed(2))
            * float(sigmas[0])).to(dev)
    big_sigmas = bench_sigmas(torch, DOWN_BIG_STEPS)
    for nt in ("highres_pyramid", "pyramid_old"):
        reset_counts()
        o = sample_sonar_euler_ancestral(denoiser, xbig, big_sigmas, seed=7,
                                         sonar_config=SonarConfig(noise_type=nt))
        c = down_launches[f"{nt} {DOWN_BIG}"] = read_counts()
        need(o.shape == DOWN_BIG and bool(torch.isfinite(o).all()),
             f"{nt} path at {DOWN_BIG} malformed or not finite")
        print(f"[9] {nt} path at {DOWN_BIG} (B5 kernel 2): {DOWN_BIG_STEPS} steps, output "
              f"std {float(o.std()):.4f}; launches {c}")
        need(c["B5"] == DOWN_BIG_STEPS and c["B1"] == DOWN_BIG_STEPS
             and c["B2"] == DOWN_BIG_STEPS and c["B4"] == 0 and c["B7"] == att4 * DOWN_BIG_STEPS,
             f"{nt} at {DOWN_BIG}: expected {DOWN_BIG_STEPS} launches of B5, B1 and B2, "
             f"got {c}")
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(get_noise_item(nt), DOWN_BIG, device="cpu", **kw)
        gfn, gst = make_noise_sampler(get_noise_item(nt), DOWN_BIG, device=dev, **kw)
        _, rel = rel_err(gfn(gst, 1.0, 0.9)[0], cfn(cst, 1.0, 0.9)[0])
        print(f"[9] {nt} at {DOWN_BIG}: seed 1234, CPU (plain) vs card (kernel 2): max rel "
              f"diff {rel:.3e} (tolerance {XDEV_TOL:g})")
        need(rel <= XDEV_TOL, f"{nt} at {DOWN_BIG}: CPU and card streams differ ({rel:.3e})")
    del xbig, o

    for nt in ("gaussian", "pyramid", "highres_pyramid", "pyramid_old"):
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(get_noise_item(nt), SHAPE, device="cpu", **kw)
        gfn, gst = make_noise_sampler(get_noise_item(nt), SHAPE, device=dev, **kw)
        worst = 0.0
        for _ in range(3):
            a, cst = cfn(cst, 1.0, 0.9)
            b, gst = gfn(gst, 1.0, 0.9)
            need(a.device.type == "cpu" and b.is_cuda, f"{nt}: draws on the wrong device")
            _, rel = rel_err(b, a)
            worst = max(worst, rel)
        print(f"[9] {nt}: seed 1234, 3 draws, CPU (plain) vs card (kernels): max rel "
              f"diff {worst:.3e} (tolerance {XDEV_TOL:g})")
        need(worst <= XDEV_TOL, f"{nt}: CPU and card streams differ ({worst:.3e})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with plain_versions():
        nfn, nst = make_noise_sampler(
            get_noise_item("pyramid"), SHAPE, dtype=torch.float32, device=dev,
            sigma_min=float(sigmas[sigmas > 0].min()), sigma_max=float(sigmas.max()),
            seed=derive_seed(seed_from(7), "noise"), normalized=True, ref_latent=x0)
        sl = sigmas.tolist()
        pdraws = []
        for i in range(STEPS):
            d, nst = nfn(nst, sl[i], sl[i + 1])
            pdraws.append(d)
    kern = headline(sonar_config=pyr_cfg)
    plain = sample_sonar_euler_ancestral(denoiser, x0, sigmas, use_fused=False,
                                         noise_sampler=lambda i, s, sn: pdraws[i])
    torch.cuda.synchronize()
    err, rel = rel_err(kern, plain)
    print(f"[9] pyramid path (kernels) vs the sampler fed the plain versions' draws "
          f"(plain momentum step), TF32 off: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"pyramid trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 10: timing -------------------------------------------------------
    print(f"[10] {time.perf_counter() - t_run:.0f} s into the run")
    print(f"[10] timing on {card} (cudnn TF32 on, matmul TF32 off)")
    runs = {"gaussian": lambda: headline(), "pyramid": lambda: headline(sonar_config=pyr_cfg)}
    ms = {"gaussian": [], "pyramid": []}
    for which in ("gaussian", "pyramid", "pyramid", "gaussian"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[10] steps/s: pyramid path {sps['pyramid']:.2f} (runs "
          f"{[round(v, 3) for v in ms['pyramid']]} ms), gaussian headline "
          f"{sps['gaussian']:.2f} (runs {[round(v, 3) for v in ms['gaussian']]} ms) [{card}]")

    def draws(nt, shape, iters):
        fn, st = make_noise_sampler(get_noise_item(nt), shape, device=dev, seed=3,
                                    sigma_min=0.03, sigma_max=14.6)

        def run():
            s = st
            for _ in range(iters):
                _, s = fn(s, 1.0, 0.9)

        return run

    mshape, miters = (1, 4, 128, 128), 50
    mpix = {}
    for which in ("kernel", "composed", "composed", "kernel"):
        with composed_path() if which == "composed" else contextlib.nullcontext():
            t = cuda_ms(torch, draws("pyramid", mshape, miters), 3)
        mpix.setdefault(which, []).append(65536 * miters / (t / 1000) / 1e6)
    print(f"[10] pyramid noise at {mshape}, {miters} draws (normalized): kernel path "
          f"{[round(v, 1) for v in mpix['kernel']]} Mpix/s, composed path "
          f"{[round(v, 1) for v in mpix['composed']]} Mpix/s [{card}]")

    def generate(nt, shape):
        g, ctx = get_noise_item(nt), NoiseCtx(shape=shape, device=dev)
        st = g.init_state(ctx, 1)
        return lambda: g.generate(ctx, st, 99, 1.0, 0.9)

    def composed(fn):
        def run():
            with composed_path():
                fn()
        return run

    bshape = (4, 4, 512, 512)
    blad = G._size_ladder_pyramid(512, 512, 10, 0)
    b4 = {"kernel": cuda_ms(torch, lambda: P.fused_pyramid(5, bshape, blad, 0.7,
                                                           device=dev), 20),
          "plain": cuda_ms(torch, lambda: P.fused_pyramid_reference(5, bshape, blad, 0.7,
                                                                    device=dev), 20),
          "composed": cuda_ms(torch, composed(generate("pyramid", bshape)), 20)}
    print(f"[10] pyramid draw at {bshape} (B3 small levels + B4): kernel "
          f"{b4['kernel'] * 1000:.1f} us, plain {b4['plain'] * 1000:.1f} us, composed "
          f"path {b4['composed'] * 1000:.1f} us per draw [{card}]")
    # B4 alone on the device beside the composed path (Philox levels through
    # scale_samples' dense products), in turns, at the large shape and the path's
    def b4_device(shape, lad, iters):
        kf = lambda: P.fused_pyramid(5, shape, lad, 0.7, device=dev)  # noqa: E731
        cf = composed(generate("pyramid", shape))
        got = {"B4": [], "B3": [], "composed": []}
        for which in ("kernel", "composed", "composed", "kernel"):
            if which == "kernel":
                _, by = device_us(torch, kf, iters)
                got["B4"].append(sum(v for k, v in by.items() if "pyramid_up_kernel" in k))
                got["B3"].append(sum(v for k, v in by.items() if "philox_fill" in k))
            else:
                got["composed"].append(device_us(torch, cf, iters)[0])
        return got

    b4_dev = {}
    for shape, lad, iters in ((bshape, blad, 10), (SHAPE, ladder, 50)):
        got = b4_dev[shape] = b4_device(shape, lad, iters)
        bound = b4_bound(shape, lad, "bilinear", gen=True)
        need(all(got["B4"]) and all(got["composed"]), "B4: device time not measured")
        print(f"[10] pyramid draw at {shape}, ladder {lad}, device time per draw: B4 alone "
              f"{[round(v, 2) for v in got['B4']]} us (bound {bound['us']:.2f} us by "
              f"{bound['by']}: {bound['bytes'] / 1e6:.3f} MB, {bound['instr'] / 1e6:.2f} M "
              f"operations), {len(lad) - 1} B3 launches {[round(v, 2) for v in got['B3']]} "
              f"us; composed path {[round(v, 2) for v in got['composed']]} us [{card}]")
    # B5: both kernels in turns at three shapes on both ladders, beside the
    # bound; events, the plain version and the composed path at bench.py's shape
    for dshape in (SHAPE, (1, 4, 128, 128), (4, 4, 512, 512)):
        dbase = randn(dshape)
        hl = G._size_ladder_highres(*dshape[2:], 4, 0)
        old = [(dshape[2] * 2 ** (i + 1), dshape[3] * 2 ** (i + 1)) for i in range(5)]
        b5_cases = {
            "pyramid_old": (old, [(0.5**i) * 0.8**i for i in range(5)], "nearest-exact", None),
            "highres_pyramid": (hl, [0.7**i for i in range(len(hl))], "bilinear", dbase),
        }
        for nt, (sz, cf, mode, b) in b5_cases.items():
            def kf(sz=sz, cf=cf, mode=mode, b=b, dshape=dshape):
                return P.fused_downscale_pyramid(5, dshape, sz, cf, mode, base=b, device=dev)
            got = {1: [], 2: []}
            for v in (1, 2, 2, 1):
                with P._forced_down_variant(v):
                    got[v].append(device_us(torch, kf, 20)[0])
            need(all(got[1]) and all(got[2]), "B5: device time not measured")
            pick = P.downscale_variant(math.prod(dshape))
            bd5 = b5_bound(P, dshape, sz, cf, mode, base=b is not None)
            line = (f"[10] B5 {nt} at {dshape}, ladder {sz}: device time spread kernel "
                    f"{[round(x, 2) for x in got[1]]} us, one thread a group "
                    f"{[round(x, 2) for x in got[2]]} us; the wrapper picks kernel {pick} "
                    f"(bound {bd5['us']:.2f} us by {bd5['by']})")
            if dshape == (1, 4, 128, 128):
                k = cuda_ms(torch, kf, 50)
                p = cuda_ms(torch, lambda: P.fused_downscale_pyramid_reference(
                    5, dshape, sz, cf, mode, base=b, device=dev), PLAIN_CALLS)
                c = cuda_ms(torch, composed(generate(nt, dshape)), 5)
                line += (f"; by events kernel {k * 1000:.1f} us, plain {p * 1000:.1f} us, "
                         f"composed path (oversized levels built) {c * 1000:.1f} us per draw")
            print(f"{line} [{card}]")
        del dbase
    lshape = B3_SHAPES[-1]
    b3_fns = {"kernel": lambda: H.philox_randn(5, lshape, device=dev),
              "torch.randn": lambda: torch.randn(lshape, device=dev),
              "plain": lambda: H.philox_randn_reference(5, lshape, device=dev)}
    b3 = {k: cuda_ms(torch, f, 20) for k, f in b3_fns.items()}
    b3_dev = {k: [] for k in ("kernel", "torch.randn")}
    for which in ("kernel", "torch.randn", "torch.randn", "kernel"):
        b3_dev[which].append(device_us(torch, b3_fns[which], 20)[0])
    n = math.prod(lshape)
    bd3 = b3_bound(n)
    need(all(b3_dev["kernel"]) and all(b3_dev["torch.randn"]), "B3: device time not measured")
    print(f"[10] B3 at {lshape} ({n} elements): device time kernel "
          f"{[round(v, 2) for v in b3_dev['kernel']]} us "
          f"({4 * n / (min(b3_dev['kernel']) * 1e-6) / 1e9:.0f} GB/s written; bound "
          f"{bd3['us']:.2f} us by {bd3['by']}), torch.randn "
          f"{[round(v, 2) for v in b3_dev['torch.randn']]} us, kernel / torch.randn "
          f"{sum(b3_dev['kernel']) / sum(b3_dev['torch.randn']):.3f}; by events kernel "
          f"{b3['kernel'] * 1000:.1f} us, torch.randn {b3['torch.randn'] * 1000:.1f} us, "
          f"plain {b3['plain'] * 1000:.1f} us [{card}]")
    for dt in (torch.bfloat16, torch.float16):
        kd = device_us(torch, lambda: H.philox_randn(5, lshape, device=dev, dtype=dt), 20)[0]
        kl = device_us.launched
        ld = device_us(torch, lambda: torch.randn(lshape, device=dev, dtype=dt), 20)[0]
        print(f"[10] B3 at {lshape} in {dt}: device time kernel {fmt_us(kd)} ({kl:.0f} "
              f"device kernel a call), torch.randn {fmt_us(ld)} [{card}]")

    # the path's calls at its shape: events (host cost included) and device time
    hl64 = G._size_ladder_highres(*SHAPE[2:], 4, 0)
    hc64 = [0.7**i for i in range(len(hl64))]
    pbase = randn(SHAPE)
    path_fns = {
        "B3": (lambda: H.philox_randn(5, SHAPE, device=dev),
               lambda: H.philox_randn_reference(5, SHAPE, device=dev)),
        "B4": (lambda: P.fused_pyramid(5, SHAPE, ladder, 0.7, device=dev),
               lambda: P.fused_pyramid_reference(5, SHAPE, ladder, 0.7, device=dev)),
        "B5": (lambda: P.fused_downscale_pyramid(5, SHAPE, hl64, hc64, base=pbase,
                                                 device=dev),
               lambda: P.fused_downscale_pyramid_reference(5, SHAPE, hl64, hc64,
                                                           base=pbase, device=dev)),
    }
    for k, (kf, pf) in path_fns.items():
        # the plain versions are thousands of torch ops a call (B5's ~35 ms of
        # host): PLAIN_CALLS by events and PLAIN_PROFILED under the profiler
        timing[k] = (cuda_ms(torch, kf, 200), cuda_ms(torch, pf, PLAIN_CALLS))
        (kd, kby), (pd, _) = device_us(torch, kf, 50), device_us(torch, pf, PLAIN_PROFILED)
        # B4's draw also launches B3 for the small levels: B4 is its own kernel's time
        dev_timing[k] = (sum(v for n_, v in kby.items() if "pyramid_up_kernel" in n_)
                         if k == "B4" else kd, pd)
        by = ", ".join(f"{n_}: {v:.2f} us" for n_, v in sorted(kby.items()))
        print(f"[10] {k} at {SHAPE} as the path calls it: kernel "
              f"{timing[k][0] * 1000:.2f} us/call, plain {timing[k][1] * 1000:.2f} "
              f"us/call (events, host cost included); device time kernel {fmt_us(kd)} "
              f"({by}), plain {fmt_us(pd)} [{card}]")

    library_us = {"B3": device_us(torch, lambda: torch.randn(SHAPE, device=dev), 50)[0],
                  "B4": sum(b4_dev[SHAPE]["composed"]) / 2}
    print(f"[10] PyTorch routes for the same functions at {SHAPE}, device time: torch.randn "
          f"{fmt_us(library_us['B3'])} (B3), the composed pyramid draw "
          f"{fmt_us(library_us['B4'])} (B4) [{card}]")

    # -- phase 11: B6 against its plain version -------------------------------
    print(f"[11] {time.perf_counter() - t_run:.0f} s into the run")
    b6_err, b6_cases = 0.0, 0
    dists = [("euclidean", 3.0), ("quadratic", 3.0), ("chebyshev", 3.0), ("minkowski", 2.5)]

    def b6_case(fp, ys, xs, z, what, **kw):
        nonlocal b6_err, b6_cases
        o = V.voronoi_ksmallest(fp, ys, xs, z, **kw)
        r = V.voronoi_ksmallest_reference(fp, ys, xs, z, **kw)
        torch.cuda.synchronize()
        need(o.is_cuda and o.shape == r.shape and o.dtype == torch.float32,
             "B6 output malformed")
        err, rel = rel_err(o, r)
        b6_err = max(b6_err, err)
        b6_cases += 1
        if kw["dist"] == "minkowski":
            need(rel <= B6_TOL, f"B6 {what} {kw}: rel err {rel:.3e}")
        else:
            need(torch.equal(o, r), f"B6 {what} {kw}: not bit-equal ({err:.3e})")

    def b6_inputs(b, c, h, w, n_pts):
        return (torch.rand((b, c, n_pts, 3), generator=gen, device=dev),
                torch.arange(h, dtype=torch.float32, device=dev) / h,
                torch.arange(w, dtype=torch.float32, device=dev) / w)

    for n_pts in B6_POINTS:
        for shape in B6_SHAPES:
            fp, ys, xs = b6_inputs(*shape, n_pts)
            z = torch.tensor(0.37, device=dev)
            for dist, p in dists:
                for k in (1, 2, 4, 8):
                    for scale, wts in ((1.0, (1.0, 1.0, 1.0)), (8.0, (2.0, 1.0, 0.25))):
                        b6_case(fp, ys, xs, z, f"N={n_pts} {shape}", scale=scale, k=k,
                                dist=dist, p=p, weights=wts)
    print(f"[11] B6 voronoi_ksmallest vs plain: {b6_cases} cases (N {B6_POINTS}, shapes "
          f"{B6_SHAPES}, 4 distances, k 1/2/4/8, plain and weighted x8): euclidean, "
          f"quadratic, chebyshev bit-equal; max abs err {b6_err:.3e} (minkowski tolerance "
          f"{B6_TOL:g} x max(1,|plain|))")
    first = b6_cases
    for n_pts in B6_TILE_POINTS:
        for shape in B6_TILE_SHAPES:
            fp, ys, xs = b6_inputs(*shape, n_pts)
            for dist, p in dists:
                for k in (1, 3, 8):
                    b6_case(fp, ys, xs, 0.37, f"N={n_pts} {shape}", scale=3.0, k=k,
                            dist=dist, p=p, weights=(1.0, 1.5, 0.5))
    # the generator's call: strided views of the grid, a 0-dim z, points outside [0, 1)
    h, w = 67, 61
    fp, ys, xs = b6_inputs(1, 3, h, w, 50)
    grid3d = torch.cat([torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1),
                        torch.tensor(0.81, device=dev).expand(h, w, 1)], dim=-1)
    for dist, p in dists:
        b6_case(fp * 3.0 - 1.0, grid3d[:, 0, 0], grid3d[0, :, 1], grid3d[0, 0, 2],
                "strided grid", scale=2.0, k=2, dist=dist, p=p, weights=(1.0, 1.0, 1.0))
    print(f"[11] B6 tiles and splits: {b6_cases - first} more cases (shapes {B6_TILE_SHAPES}: "
          f"tiles of 4, 8, 16 and 32 rows; N {B6_TILE_POINTS}, k 1/3/8 with k = N = 8; "
          f"strided grid vectors, points outside [0, 1)): same limits, max abs err "
          f"{b6_err:.3e}")

    # -- phase 12: the Voronoi path ---------------------------------------------
    print(f"[12] {time.perf_counter() - t_run:.0f} s into the run")
    vor_cfg = SonarConfig(noise_type="voronoi_mix")
    reset_counts()
    vout = headline(sonar_config=vor_cfg)
    vor_launches = read_counts()
    need(vout.is_cuda and vout.shape == SHAPE and bool(torch.isfinite(vout).all()),
         "voronoi path output malformed or not finite")
    vstd = float(vout.std())
    need(1.0 < vstd < 100.0, f"voronoi path output std {vstd} implausible")
    # per step: B1, B2 once; B6 once per octave (3); B3 three point draws
    # (reset mode, z_max 0) and the gaussian member; three point draws at set-up
    want = {"B1": STEPS, "B2": STEPS, "B3": 4 * STEPS + 3, "B4": 0, "B5": 0, "B6": 3 * STEPS,
            "B7": att4 * STEPS}
    print(f"[12] voronoi_mix path: UNetConfig() {SHAPE}, {STEPS} steps, seed 7: output std "
          f"{vstd:.4f}; launches {vor_launches}")
    need(vor_launches == want, f"voronoi path: expected launches {want}")
    need(torch.equal(vout, headline(sonar_config=vor_cfg)), "voronoi path not reproducible")
    need(not torch.equal(vout, out), "voronoi path equals the gaussian headline")

    chain_item = lambda: NoiseChain([VoronoiGenerator(  # noqa: E731
        1.0, n_points=(128,), octaves=2, octave_mode="new_features", result_mode=("f3",),
        distance_mode=("weight:name=euclidean:h=1.5",), z_max=3.0, z_max_mode="bounce")])
    short_cases = {
        # generic path (fuzz of angle_tanh): B3 for the points and the fuzz
        # each step, the points once at set-up; no B6
        "voronoi_fuzz": (SonarConfig(noise_type="voronoi_fuzz"),
                         {"B1": SHORT_STEPS, "B2": SHORT_STEPS, "B3": 2 * SHORT_STEPS + 1,
                          "B4": 0, "B5": 0, "B6": 0, "B7": att4 * SHORT_STEPS}),
        # bounce mode draws points only at set-up (two groups); B6 per octave
        "custom_noise": (SonarConfig(custom_noise=chain_item()),
                         {"B1": SHORT_STEPS, "B2": SHORT_STEPS, "B3": 2, "B4": 0, "B5": 0,
                          "B6": 2 * SHORT_STEPS, "B7": att4 * SHORT_STEPS}),
    }
    for nt, (c, want) in short_cases.items():
        reset_counts()
        o = sample_sonar_euler_ancestral(denoiser, x0, short, seed=7, sonar_config=c)
        got = read_counts()
        need(bool(torch.isfinite(o).all()), f"{nt} path not finite")
        print(f"[12] {nt} path: {SHORT_STEPS} steps, output std {float(o.std()):.4f}; "
              f"launches {got}")
        need(got == want, f"{nt}: expected launches {want}")
        need(torch.equal(o, sample_sonar_euler_ancestral(denoiser, x0, short, seed=7,
                                                         sonar_config=c)),
             f"{nt} path not reproducible")

    xdev_items = {"voronoi_mix": lambda: get_noise_item("voronoi_mix"),
                  "voronoi_fuzz": lambda: get_noise_item("voronoi_fuzz"),
                  "custom_noise": chain_item}
    for nt, make in xdev_items.items():
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(make(), SHAPE, device="cpu", **kw)
        gfn, gst = make_noise_sampler(make(), SHAPE, device=dev, **kw)
        worst = 0.0
        for _ in range(3):
            a, cst = cfn(cst, 1.0, 0.9)
            b, gst = gfn(gst, 1.0, 0.9)
            need(a.device.type == "cpu" and b.is_cuda, f"{nt}: draws on the wrong device")
            _, rel = rel_err(b, a)
            worst = max(worst, rel)
        print(f"[12] {nt}: seed 1234, 3 draws, CPU (plain) vs card (kernels): max rel diff "
              f"{worst:.3e} (tolerance {XDEV_TOL:g})")
        need(worst <= XDEV_TOL, f"{nt}: CPU and card streams differ ({worst:.3e})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with plain_versions():
        nfn, nst = make_noise_sampler(
            get_noise_item("voronoi_mix"), SHAPE, dtype=torch.float32, device=dev,
            sigma_min=float(sigmas[sigmas > 0].min()), sigma_max=float(sigmas.max()),
            seed=derive_seed(seed_from(7), "noise"), normalized=True, ref_latent=x0)
        vdraws = []
        for i in range(STEPS):
            d, nst = nfn(nst, sl[i], sl[i + 1])
            vdraws.append(d)
    kern = headline(sonar_config=vor_cfg)
    plain = sample_sonar_euler_ancestral(denoiser, x0, sigmas, use_fused=False,
                                         noise_sampler=lambda i, s, sn: vdraws[i])
    torch.cuda.synchronize()
    err, rel = rel_err(kern, plain)
    print(f"[12] voronoi path (kernels) vs the sampler fed the plain versions' draws "
          f"(plain momentum step), TF32 off: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"voronoi trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 13: bf16 and fp16 latents through B1 and B2 ---------------------
    print(f"[13] {time.perf_counter() - t_run:.0f} s into the run")
    for dt in (torch.bfloat16, torch.float16):
        ulp, plain_tol = LOW_TOL[str(dt).split(".")[-1]]
        worst_up, worst_plain = 0.0, 0.0
        for shape in B1_SHAPES:
            ts = [randn(shape).to(dt) for _ in range(4)]
            for has, inw, hw, ns in gates:
                scal = F.pack_momentum_scalars(
                    sigma=5.0, dt=-2.0, momentum=0.95, hd_ratio=0.75, hd_scale=1.05,
                    md_scale=1.0, has=has, noise_scale=ns, in_window=inw,
                    hist_window=hw, device=dev)
                o_k = F.fused_momentum_step(*ts, scal)
                o_u = F.fused_momentum_step_reference(*(t.float() for t in ts), scal)
                o_p = F.fused_momentum_step_reference(*ts, scal)
                for o, u, q in zip(o_k, o_u, o_p):
                    need(o.dtype == dt and o.is_cuda, f"B1 {dt}: output dtype {o.dtype}")
                    need(torch.equal(o, u.to(dt)), f"B1 {dt} {shape}: not equal to the plain "
                                                   f"version on the float32 upcast")
                    worst_plain = max(worst_plain, rel_err(o, q)[1])
            for x, factor in ((ts[0] * 3 + 0.5, 1.0), (ts[1] * 2 + 0.25, 1.7), (ts[2], 1.0)):
                x = x.to(dt)
                o = F.fused_scale_noise(x, factor)
                u = F.fused_scale_noise_reference(x.float(), factor).to(dt)
                need(o.dtype == dt and torch.equal(o, F.fused_scale_noise(x, factor)),
                     f"B2 {dt}: dtype or repeatability")
                e = float(((o.double() - u.double()).abs()
                           / u.double().abs().clamp(min=1)).max())
                worst_up = max(worst_up, e)
                need(e <= ulp, f"B2 {dt} {shape}: {e:.3e} from the float32 upcast")
                worst_plain = max(worst_plain, rel_err(o, F.fused_scale_noise_reference(
                    x, factor))[1])
        limits = [(shape[0], b2_hold(shape, dt, ulp)[1]) for shape in b2_limit_shapes]
        print(f"[13] B2 on {dt} at its launches' size limits (elements, tier): {limits}: 6 "
              f"branch cases each within one ulp of the plain version on the float32 "
              f"upcast, bitwise equal across runs, one device kernel a call")
        torch.cuda.synchronize()
        print(f"[13] B1/B2 on {dt}: B1 equal to the plain version on the float32 upcast; B2 "
              f"within {worst_up:.3e} of it (one ulp {ulp:g}); against the plain version "
              f"run in {dt}: {worst_plain:.3e} (tolerance {plain_tol:g}) x max(1,|plain|)")
        need(worst_plain <= plain_tol, f"{dt}: kernels and plain versions differ")

    target = (torch.arange(4 * 64 * 64, dtype=torch.float32, device=dev).reshape(SHAPE)
              / 1e3).to(torch.bfloat16)

    def stub(xb, sig, **_):
        return ((xb * 0.9 + target) / (1.0 + sig.reshape(-1, 1, 1, 1) * 0.05)).to(xb.dtype)

    xb = x0.to(torch.bfloat16)
    reset_counts()
    bout = sample_sonar_euler_ancestral(stub, xb, sigmas, seed=7)
    bf_launches = read_counts()
    need(bout.dtype == torch.bfloat16 and bout.is_cuda and bout.shape == SHAPE
         and bool(torch.isfinite(bout).all()), "bf16 headline output malformed")
    need(bf_launches == {"B1": STEPS, "B2": STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0,
                         "B7": 0}, f"bf16 headline launches {bf_launches}")
    bplain = sample_sonar_euler_ancestral(stub, xb, sigmas, seed=7, use_fused=False)
    berr = float((bout.double() - bplain.double()).abs().max())
    bscale = float(bplain.double().abs().max())
    print(f"[13] bf16 headline (stub denoiser, {SHAPE}, {STEPS} steps): dtype {bout.dtype}, "
          f"launches {bf_launches}; vs use_fused=False max abs diff {berr:.4f} of max "
          f"|trajectory| {bscale:.3f} (tolerance {BF16_TRAJ_TOL:g} relative)")
    need(berr <= BF16_TRAJ_TOL * bscale, "bf16 kernel and plain trajectories differ")

    # -- phase 14: timing -------------------------------------------------------
    print(f"[14] {time.perf_counter() - t_run:.0f} s into the run")
    print(f"[14] timing on {card} (cudnn TF32 on, matmul TF32 off)")
    runs = {"gaussian": lambda: headline(), "voronoi": lambda: headline(sonar_config=vor_cfg)}
    ms = {"gaussian": [], "voronoi": []}
    for which in ("gaussian", "voronoi", "voronoi", "gaussian"):
        ms[which].append(cuda_ms(torch, runs[which], 3))
    sps = {k: STEPS / (sum(v) / len(v) / 1000.0) for k, v in ms.items()}
    print(f"[14] steps/s: voronoi_mix path {sps['voronoi']:.2f} (runs "
          f"{[round(v, 3) for v in ms['voronoi']]} ms), gaussian headline "
          f"{sps['gaussian']:.2f} (runs {[round(v, 3) for v in ms['gaussian']]} ms) [{card}]")
    # where a run's device time goes, and the device's busy share of the run
    for which in ("gaussian", "voronoi"):
        tot, by = device_us(torch, runs[which], 1)
        if tot is None:
            print(f"[14] {which} run: device time not measured [{card}]")
            continue
        parts = {"B6": "voronoi_ksmallest_kernel", "B3": "philox_fill",
                 "B1": "momentum_step_kernel", "B2": "scale_noise_"}
        got = {k: sum(v for n_, v in by.items() if pat in n_) for k, pat in parts.items()}
        wall = sum(ms[which]) / len(ms[which]) * 1000
        print(f"[14] {which} run, {device_us.launched:.0f} device kernels, device time: "
              f"{tot:.1f} us of {wall:.1f} us wall "
              f"(busy {100 * tot / wall:.1f} %); {', '.join(f'{k} {v:.1f} us' for k, v in got.items())}"
              f", the rest (UNet, torch ops) {tot - sum(got.values()):.1f} us [{card}]")

    def b6_fns(shape, k, n_pts=256):
        fp = torch.rand((shape[0], shape[1], n_pts, 3), generator=gen, device=dev)
        ys = torch.arange(shape[2], dtype=torch.float32, device=dev) / shape[2]
        xs = torch.arange(shape[3], dtype=torch.float32, device=dev) / shape[3]
        z = torch.tensor(0.25, device=dev)
        return (lambda: V.voronoi_ksmallest(fp, ys, xs, z, scale=2.0, k=k),
                lambda: V.voronoi_ksmallest_reference(fp, ys, xs, z, scale=2.0, k=k))

    kf, pf = b6_fns(SHAPE, 2)
    timing["B6"] = (cuda_ms(torch, kf, 200), cuda_ms(torch, pf, 200))
    (kd, kby), (pd, _) = device_us(torch, kf, 50), device_us(torch, pf, 50)
    dev_timing["B6"] = (kd, pd)
    print(f"[14] B6 at {SHAPE}, N=256, k=2 as the path calls it: kernel "
          f"{timing['B6'][0] * 1000:.2f} us/call, plain {timing['B6'][1] * 1000:.2f} us/call "
          f"(events, host cost included); device time kernel {fmt_us(kd)} "
          f"({', '.join(f'{n_}: {v:.2f} us' for n_, v in sorted(kby.items()))}), plain "
          f"{fmt_us(pd)} [{card}]")
    for shape in (SHAPE, VORONOI_BENCH):
        px = shape[0] * shape[1] * shape[2] * shape[3]
        for k in (1, 2, 4, 8):
            kf, pf = b6_fns(shape, k)
            ke = cuda_ms(torch, kf, 100)
            (kd, kby), (pd, _) = device_us(torch, kf, 20), device_us(torch, pf, 5)
            b6k = sum(v for n_, v in kby.items() if "voronoi" in n_)
            need(b6k > 0, "B6: device time not measured")
            bd = b6_bound(shape, 256, k)
            print(f"[14] B6 at {shape}, N=256, k={k}: kernel {ke * 1000:.2f} us/call "
                  f"(events), device {fmt_us(kd)} (B6 alone {b6k:.2f} us, "
                  f"{px * 256 / (b6k * 1e-6) / 1e9:.1f} G pixel-points/s; bound "
                  f"{bd['us']:.2f} us by {bd['by']}); plain device {fmt_us(pd)} [{card}]")

    # f1 (k = 1): B6, the route the generator takes, against the per-axis path and a min
    h1, w1 = VORONOI_BENCH[2], VORONOI_BENCH[3]
    g1 = VoronoiGenerator(n_points=(256,))
    need(g1._kernel_plan(NoiseCtx(shape=VORONOI_BENCH, device=dev), 0, h1, w1)
         == ("euclidean", 3.0, None, 1.0, 1), "f1 does not plan kernel B6")
    fp1 = torch.rand((1, 4, 256, 3), generator=gen, device=dev)
    ys1 = torch.arange(h1, dtype=torch.float32, device=dev) / h1
    xs1 = torch.arange(w1, dtype=torch.float32, device=dev) / w1
    z1 = torch.tensor(0.25, device=dev)
    grid3d = torch.cat([torch.stack(torch.meshgrid(ys1, xs1, indexing="ij"), dim=-1),
                        z1.expand(h1, w1, 1)], dim=-1)
    axis_k1 = lambda: VN._sorted_small(  # noqa: E731
        g1._axis_distance(("euclidean", 3.0, None, 1.0), grid3d, fp1, 1.0), 1)
    kern_k1 = lambda: V.voronoi_ksmallest(fp1, ys1, xs1, z1, scale=1.0, k=1)  # noqa: E731
    need(torch.equal(axis_k1()[..., 0], kern_k1()[..., 0]), "k=1: per-axis path and B6 differ")
    ae, ke = cuda_ms(torch, axis_k1, 50), cuda_ms(torch, kern_k1, 50)
    ad, kd = device_us(torch, axis_k1, 10)[0], device_us(torch, kern_k1, 10)[0]
    print(f"[14] f1 (k=1) at {VORONOI_BENCH}, N=256: B6 {ke * 1000:.2f} us/call (device "
          f"{fmt_us(kd)}), per-axis path + min {ae * 1000:.2f} us/call (device "
          f"{fmt_us(ad)}); equal outputs [{card}]")

    def vdraws_run(item, iters):
        fn, st = make_noise_sampler(item, VORONOI_BENCH, device=dev, seed=5, sigma_min=0.03,
                                    sigma_max=14.6)

        def run():
            s_ = st
            for _ in range(iters):
                _, s_ = fn(s_, 1.0, 0.9)

        return run

    never = lambda *a: False  # noqa: E731
    viters = 20
    px = VORONOI_BENCH[0] * VORONOI_BENCH[2] * VORONOI_BENCH[3]
    for label, kw in (("bench (f1, 2 octaves)", {}),
                      ("diff2, 2 octaves", {"result_mode": ("diff2",)})):
        mp = {}
        for which in ("kernel", "plain", "plain", "kernel"):
            ctx = (patched(VN, voronoi_kernel_supported=never) if which == "plain"
                   else contextlib.nullcontext())
            with ctx:
                t = cuda_ms(torch, vdraws_run(VoronoiGenerator(n_points=(256,), octaves=2,
                                                               **kw), viters), 2)
            mp.setdefault(which, []).append(px * viters / (t / 1000) / 1e6)
        print(f"[14] voronoi noise {label} at {VORONOI_BENCH}, 256 points, {viters} draws "
              f"(normalized): as routed {[round(v, 2) for v in mp['kernel']]} Mpix/s, gate "
              f"closed (per-axis path) {[round(v, 2) for v in mp['plain']]} Mpix/s [{card}]")
    mp = []
    for _ in range(2):
        t = cuda_ms(torch, vdraws_run(get_noise_item("voronoi_mix"), viters), 2)
        mp.append(px * viters / (t / 1000) / 1e6)
    print(f"[14] voronoi_mix noise at {VORONOI_BENCH}: {[round(v, 2) for v in mp]} Mpix/s "
          f"[{card}]")

    # -- phase 15: the config-3a path ---------------------------------------------
    print(f"[15] {time.perf_counter() - t_run:.0f} s into the run")
    def noise_3a():
        """bench.py:468-471: scheduled time-brownian power noise, gaussian outside."""
        return ScheduledNoise(
            noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
            start_sigma=14.7, end_sigma=0.3, fallback_noise=get_noise_item("gaussian"))

    sde_cfg = SonarConfig(momentum=0.95)

    def sde(**kw):
        kw.setdefault("noise_item", noise_3a())
        return sample_sonar_dpmpp_sde(denoiser, x0, sigmas, sonar_config=sde_cfg, seed=7, **kw)

    n_sde = len(sl) - 1  # 20 steps: 19 two-stage ones and the tail
    sde_sched = _dpmpp_sde_schedule(sl, 1.0, 1.0, 0.5)
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    # steps whose draws fall in the window (it is read at s_t, the step's start)
    n_in = sum(f32(0.3) <= st_ <= f32(14.7) for st_ in sde_sched["s_t"])
    need(0 < n_in < n_sde and all(f32(0.3) <= st_ for st_ in sde_sched["s_t"][:n_in]),
         "config 3a: the window does not split the schedule")
    calls = []

    def counted(xi, s_in, **kw):
        calls.append(s_in.dtype)
        return denoiser(xi, s_in, **kw)

    reset_counts()
    sout = sample_sonar_dpmpp_sde(counted, x0, sigmas, sonar_config=sde_cfg, seed=7,
                                  noise_item=noise_3a())
    sde_launches = read_counts()
    need(sout.is_cuda and sout.shape == SHAPE and sout.dtype == torch.float32
         and bool(torch.isfinite(sout).all()), "config-3a output malformed or not finite")
    sstd = float(sout.std())
    # with history the two-stage step blends 5 % of it into each stage's
    # direction, which on a near-identity denoiser (random weights) shrinks
    # the latent a little at every stage: well under sigma_0 by the end
    need(0.01 < sstd < 100.0, f"config-3a output std {sstd} implausible")
    need(len(calls) == 2 * (n_sde - 1) + 1 and set(calls) == {torch.float32},
         f"config 3a: {len(calls)} model calls with sigma types {set(calls)}")
    # a step in the window: the first draw finds W(s_t) cached (17 B3 launches
    # for W(s_s)), the second does not (34: W(s_t), W(sigma_next)); the first
    # step has no cache yet; outside the window two gaussian draws; B2 once a
    # draw, at the ScheduledNoise; the tail draws twice as every step
    want = {"B1": 0, "B2": 2 * n_sde, "B3": 51 * n_in + 17 + 2 * (n_sde - n_in), "B4": 0,
            "B5": 0, "B6": 0, "B7": att4 * len(calls)}
    print(f"[15] config-3a path: sample_sonar_dpmpp_sde, momentum 0.95, scheduled "
          f"time-brownian power noise, UNetConfig() {SHAPE}, {n_sde - 1} steps and the tail, "
          f"seed 7, {len(calls)} model calls, {n_in} steps in the noise window: output std "
          f"{sstd:.4f}, mean {float(sout.mean()):.4f}; launches {sde_launches}")
    need(sde_launches == want, f"config-3a path: expected launches {want}")
    need(torch.equal(sout, sde()), "config-3a path not reproducible")
    need(not torch.equal(sout, out), "config-3a path equals the gaussian headline")

    reset_counts()
    bout = sample_sonar_dpmpp_sde(denoiser, x0, short, seed=7)
    brown_launches = read_counts()
    # every step on the Brownian path: 51 B3 launches a step, 17 more on the
    # first, 17 fewer on the tail (its midpoint lies below sigma_min and is
    # clipped to u = 0, which is u(s_t) there: the second draw hits the cache)
    want = {"B1": 0, "B2": 2 * SHORT_STEPS, "B3": 51 * SHORT_STEPS, "B4": 0, "B5": 0, "B6": 0,
            "B7": att4 * (2 * (SHORT_STEPS - 1) + 1)}
    need(bool(torch.isfinite(bout).all()) and bout.shape == SHAPE, "brownian path not finite")
    print(f"[15] default noise (brownian): sample_sonar_dpmpp_sde, {SHORT_STEPS - 1} steps "
          f"and the tail: output std {float(bout.std()):.4f}; launches {brown_launches}")
    need(brown_launches == want, f"brownian path: expected launches {want}")
    need(torch.equal(bout, sample_sonar_dpmpp_sde(denoiser, x0, short, seed=7)),
         "brownian path not reproducible")

    # a bfloat16 latent: the step runs in float32 (the midpoint call sees a
    # float32 latent), the carry is rounded once a step, the noise is drawn
    # and filtered in float32 (cuFFT takes no bfloat16) and cast
    seen = []

    def typed(xi, s_in, **kw):
        seen.append((xi.dtype, s_in.dtype))
        return denoiser(xi, s_in, **kw)

    reset_counts()
    hout = sample_sonar_dpmpp_sde(typed, x0.bfloat16(), short, sonar_config=sde_cfg, seed=7,
                                  noise_item=noise_3a())
    half_launches = read_counts()
    fout = sample_sonar_dpmpp_sde(denoiser, x0.bfloat16().float(), short,
                                  sonar_config=sde_cfg, seed=7, noise_item=noise_3a())
    need(hout.dtype == torch.bfloat16 and hout.is_cuda and bool(torch.isfinite(hout).all()),
         "config-3a path, bfloat16 latent: malformed or not finite")
    need(seen == [(torch.bfloat16, torch.float32), (torch.float32, torch.float32)]
         * (SHORT_STEPS - 1) + [(torch.bfloat16, torch.float32)],
         f"config-3a path, bfloat16 latent: model calls saw {seen}")
    need(half_launches["B1"] == 0 and half_launches["B2"] == 2 * SHORT_STEPS
         and half_launches["B3"] > 0 and half_launches["B7"] == att4 * len(seen),
         f"config-3a path, bfloat16 latent: {half_launches}")
    err, rel = rel_err(hout.float(), fout)
    print(f"[15] config-3a path, bfloat16 latent, {SHORT_STEPS - 1} steps and the tail: "
          f"output std {float(hout.float().std()):.4f}; launches {half_launches}; against the "
          f"float32 run from the same rounded start: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {BF16_TRAJ_TOL:g}: {SHORT_STEPS} roundings of the carry)")
    need(rel <= BF16_TRAJ_TOL, f"config-3a path: bfloat16 and float32 runs differ {rel:.3e}")

    sde_pairs = [(14.6, 9.0), (9.0, 4.0), (4.0, 3.9), (2.0, 0.31), (0.2, 0.1)]
    for nt, make in (("brownian", lambda: get_noise_item("brownian")),
                     ("scheduled power noise", noise_3a)):
        kw = dict(seed=1234, sigma_min=0.03, sigma_max=14.6, normalized=True)
        cfn, cst = make_noise_sampler(make(), SHAPE, device="cpu", **kw)
        gfn, gst = make_noise_sampler(make(), SHAPE, device=dev, **kw)
        worst = 0.0
        for s_, sn_ in sde_pairs:
            a, cst = cfn(cst, s_, sn_)
            b, gst = gfn(gst, s_, sn_)
            need(a.device.type == "cpu" and b.is_cuda, f"{nt}: draws on the wrong device")
            worst = max(worst, rel_err(b, a)[1])
        print(f"[15] {nt}: seed 1234, {len(sde_pairs)} draws (cache hits and misses, inside "
              f"and outside the window), CPU (plain) vs card (kernels): max rel diff "
              f"{worst:.3e} (tolerance {XDEV_TOL:g})")
        need(worst <= XDEV_TOL, f"{nt}: CPU and card streams differ ({worst:.3e})")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with plain_versions():
        nfn, nst = make_noise_sampler(
            noise_3a(), SHAPE, dtype=torch.float32, device=dev,
            sigma_min=float(sigmas[sigmas > 0].min()), sigma_max=float(sigmas.max()),
            seed=derive_seed(seed_from(7), "noise"), normalized=True, ref_latent=x0)
        sdraws = []
        for i in range(n_sde):
            for target in (sde_sched["s_s"][i], sl[i + 1]):
                d, nst = nfn(nst, sde_sched["s_t"][i], target)
                sdraws.append(d)
    kern = sde()
    plain = sde(noise_item=None, noise_sampler=lambda i, s, sn: sdraws[i])
    torch.cuda.synchronize()
    err, rel = rel_err(kern, plain)
    print(f"[15] config-3a path (kernels) vs the sampler fed the plain versions' draws, TF32 "
          f"off: max abs diff {err:.3e}, max rel diff {rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel <= TRAJ_TOL, f"config-3a trajectories differ: {rel:.3e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 16: timing ---------------------------------------------------------
    print(f"[16] {time.perf_counter() - t_run:.0f} s into the run")
    print(f"[16] timing on {card} (cudnn TF32 on, matmul TF32 off)")
    runs = {"gaussian": lambda: headline(), "config3a": lambda: sde()}
    ms = {"gaussian": [], "config3a": []}
    # 4 runs a side (8 until [26] needed the room)
    for which in ("gaussian", "config3a", "config3a", "gaussian"):
        ms[which] += [cuda_ms(torch, runs[which], 1) for _ in range(2)]

    def spread(vals, scale):
        v = sorted(scale / (t / 1000.0) for t in vals)
        return (v[len(v) // 2] + v[(len(v) - 1) // 2]) / 2, v[0], v[-1]

    for which, n_steps in (("config3a", n_sde), ("gaussian", STEPS)):
        med, lo, hi = spread(ms[which], n_steps)
        line = (f"[16] {which}: steps/s median {med:.2f} (min {lo:.2f}, max {hi:.2f}; "
                f"{len(ms[which])} runs of {n_steps} steps, interleaved)")
        if which == "config3a":
            cmed, clo, chi = spread(ms[which], len(calls))
            line += f"; model calls/s median {cmed:.2f} (min {clo:.2f}, max {chi:.2f})"
        print(f"{line} [{card}]")
    tot, by = device_us(torch, runs["config3a"], 1)
    need(tot is not None, "config-3a run: device time not measured")
    parts = {"B3": "philox_fill", "B2": "scale_noise_", "B1": "momentum_step_kernel",
             "FFT": "fft"}
    got = {k: sum(v for n_, v in by.items() if pat in n_.lower()) for k, pat in parts.items()}
    wall = sorted(ms["config3a"])[len(ms["config3a"]) // 2] * 1000
    print(f"[16] config-3a run, {device_us.launched:.0f} device kernels, device time: "
          f"{tot:.1f} us of {wall:.1f} us wall (median run; busy {100 * tot / wall:.1f} %); "
          f"{', '.join(f'{k} {v:.1f} us' for k, v in got.items())}, the rest (UNet, torch ops) "
          f"{tot - sum(got.values()):.1f} us [{card}]")
    need(got["B1"] == 0.0 and got["B3"] > 0 and got["B2"] > 0 and got["FFT"] > 0,
         "config-3a run: B2, B3 and the FFTs must show in the profile, B1 must not")

    # one evaluation of W, one Brownian increment on a cache hit, one power draw
    w_fn = lambda: BR.brownian_w(11, 0.37, SHAPE, device=dev)  # noqa: E731
    n0 = H.philox_randn.launches
    w_fn()
    w_launches = H.philox_randn.launches - n0
    w_host = cuda_ms(torch, w_fn, 50)
    w_tot, w_by = device_us(torch, w_fn, 20)
    w_b3 = sum(v for n_, v in w_by.items() if "philox_fill" in n_)
    print(f"[16] one evaluation of W at {SHAPE}, 16 levels: {w_launches} B3 launches, "
          f"{device_us.launched:.0f} device kernels, {w_host * 1000:.1f} us/call by events "
          f"(host cost included), device time {fmt_us(w_tot)} (B3 {w_b3:.2f} us) [{card}]")
    pfn, pst = make_noise_sampler(PowerNoiseItem(alpha=0.5, min_freq=0.05), SHAPE, device=dev,
                                  seed=3)
    p_fn = lambda: pfn(pst, None, None)  # noqa: E731
    p_host = cuda_ms(torch, p_fn, 50)
    p_tot, p_by = device_us(torch, p_fn, 20)
    p_fft = sum(v for n_, v in p_by.items() if "fft" in n_.lower())
    p_b3 = sum(v for n_, v in p_by.items() if "philox_fill" in n_)
    p_b2 = sum(v for n_, v in p_by.items() if "scale_noise_" in n_)
    print(f"[16] one rfft-domain power noise draw at {SHAPE} (normalized): "
          f"{device_us.launched:.0f} device kernels, {p_host * 1000:.1f} us/call by events, "
          f"device time {fmt_us(p_tot)} (FFT {p_fft:.2f} us, two B3 {p_b3:.2f} us, B2 "
          f"{p_b2:.2f} us) [{card}]")
    tfn, tst = make_noise_sampler(noise_3a(), SHAPE, device=dev, seed=3, sigma_min=0.03,
                                  sigma_max=14.6)
    _, tst = tfn(tst, 9.0, 4.0)
    t_fn = lambda: tfn(tst, 4.0, 2.0)  # noqa: E731  (a cache hit: one W, two FFTs, B2)
    t_host = cuda_ms(torch, t_fn, 50)
    t_tot, t_by = device_us(torch, t_fn, 20)
    t_fft = sum(v for n_, v in t_by.items() if "fft" in n_.lower())
    print(f"[16] one scheduled time-brownian power draw on a cache hit at {SHAPE}: "
          f"{device_us.launched:.0f} device kernels, {t_host * 1000:.1f} us/call by events, "
          f"device time {fmt_us(t_tot)} (rfft2 + irfft2 {t_fft:.2f} us) [{card}]")

    # -- phase 17: wavelet CFG on the card ----------------------------------------
    print(f"[17] {time.perf_counter() - t_run:.0f} s into the run")
    def config3_rules(**window):
        """bench.py:472-477: db4, level 3, periodization, float32, the diff
        scales scheduled from 8 / [7, (6, 6, 7), fill] to 6 by half-cosine."""
        return WCFGRules.build(
            wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
            diff=dict(yl_scale=8.0, yh_scales=[7.0, [6.0, 6.0, 7.0], "fill"],
                      scales_end=dict(yl_scale=6.0, yh_scales=6.0),
                      schedule="half_cosine", schedule_mode="sampling"), **window)

    def eps_pair(unet, patches=None):
        """bench.py:413-422: the cond denoiser and the uncond one, which feeds
        the UNet x·c_in·0.97; the sigma batch is float32. ``patches`` go on
        the cond UNet only (config 4's FreeU, tools/bench_configs.py:72-81)."""
        def make(scale, bp):
            @torch.no_grad()
            def den(xi, sb, **_kw):
                s4 = sb.reshape(-1, 1, 1, 1)
                xin = xi * (1.0 / torch.sqrt(1.0 + s4**2))
                return xi - s4 * unet(xin * scale if scale != 1.0 else xin, sb, block_patches=bp)
            return den
        return make(1.0, patches), make(0.97, None)

    ms3 = DiscreteSampling()
    sdxl_sig = bench_sigmas(torch, SDXL_STEPS)
    sdxl_np = sdxl_sig.numpy()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wgen = torch.Generator().manual_seed(17)
    wx, wc, wu = (torch.randn(SDXL_SHAPE, generator=wgen) * k for k in (14.6, 1.0, 1.1))

    def wargs(where, s):
        t = {k: v.to(where) for k, v in (("input", wx), ("cond_denoised", wc),
                                          ("uncond_denoised", wu))}
        return dict(t, sigma=torch.full((1,), s, dtype=torch.float32, device=where),
                    sigma_host=s, cond=t["input"] - t["cond_denoised"],
                    uncond=t["input"] - t["uncond_denoised"], cond_scale=7.0,
                    model_sampling=ms3, sample_sigmas=sdxl_np)

    windowed = config3_rules(start_sigma=10.0, end_sigma=1.0)
    cases = [("config 3, first sigma", config3_rules(), 14.6, True),
             ("config 3, last sigma", config3_rules(), 0.03, True),
             ("config 3, window edge (end_sigma 0)", config3_rules(), 0.0, True),
             ("window [1, 10], inside", windowed, 5.0, True),
             ("window [1, 10], edge", windowed, 10.0, True),
             ("window [1, 10], outside: the basic-CFG fallback", windowed, 14.6, False)]
    wcfg_err = 0.0
    for label, rules, s_, wavelet_path in cases:
        wcfg = WaveletCFG(rules=rules)
        a, b = wcfg(wargs(dev, s_)), wcfg(wargs("cpu", s_))
        need(a.is_cuda and a.shape == SDXL_SHAPE and bool(torch.isfinite(a).all()),
             f"WCFG {label}: malformed on the card")
        err, rel = rel_err(a, b)
        wcfg_err = max(wcfg_err, rel)
        plain = bool(torch.equal(a, basic_cfg(wargs(dev, s_))))
        print(f"[17] WCFG {label}, sigma {s_:g}: card vs CPU max abs diff {err:.3e}, max rel "
              f"diff {rel:.3e} (tolerance {WCFG_TOL:g}, TF32 off); equals basic CFG: {plain}")
        need(rel <= WCFG_TOL, f"WCFG {label}: card and CPU differ ({rel:.3e})")
        need(plain != wavelet_path, f"WCFG {label}: took the wrong branch")

    # one guided call of the config-3 pipeline (UNet pair + WCFG) reads nothing back
    pair = eps_pair(model)

    def config3_pipe(p, rules=None, **kw):
        return SonarPipeline(model=p[0], model_uncond=p[1], model_sampling=ms3,
                             sampler="sonar_dpmpp_sde", sonar_config=SonarConfig(momentum=0.95),
                             cfg_scale=7.0, wavelet_cfg=WaveletCFG(rules=rules or config3_rules()),
                             seed=7, **kw)

    guided = config3_pipe(pair)._denoiser(sdxl_np)
    gx, g_in = wx.to(dev), torch.full((1,), 5.0, device=dev)
    guided(gx, g_in, sigma_host=5.0)  # the first call puts the DWT's constants on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gout = guided(gx, g_in, sigma_host=5.0)
    except RuntimeError as e:
        fail(f"a guided call synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    need(bool(torch.isfinite(gout).all()), "guided call: not finite")
    print("[17] one guided call (flagship UNet pair + config-3 WCFG at 1x4x128x128, sigma 5) "
          "under torch.cuda.set_sync_debug_mode('error'): no synchronisation")
    torch.backends.cudnn.allow_tf32 = True
    wdev = wargs(dev, 5.0)
    wfn = lambda: WaveletCFG(rules=config3_rules())(wdev)  # noqa: E731
    w_host = cuda_ms(torch, wfn, 50)
    w_tot, _ = device_us(torch, wfn, 20)
    need(w_tot is not None, "WCFG call: device time not measured")
    wcfg_kernels = device_us.launched
    print(f"[17] one config-3 WCFG call at {SDXL_SHAPE}: {wcfg_kernels:.0f} device kernels, "
          f"device_us {w_tot:.2f}, {w_host * 1000:.1f} us by events (host cost included) "
          f"[{card}]")

    # -- phase 18: config 3 through SonarPipeline, flagship UNet ----------------------
    print(f"[18] {time.perf_counter() - t_run:.0f} s into the run")
    n_guided = []

    def counting(p):
        return tuple((lambda xi, sb, _f=f, **kw: (n_guided.append(1), _f(xi, sb, **kw))[1])
                     for f in p)

    reset_counts()
    p3 = config3_pipe(counting(pair), noise=noise_3a())(x0, sigmas)
    p3_launches = read_counts()
    need(p3.is_cuda and p3.shape == SHAPE and p3.dtype == torch.float32
         and bool(torch.isfinite(p3).all()), "config-3 pipeline: output malformed or not finite")
    p3std = float(p3.std())
    need(0.01 < p3std < 100.0, f"config-3 pipeline: output std {p3std} implausible")
    print(f"[18] config 3 through SonarPipeline: UNetConfig() {SHAPE}, {n_sde - 1} steps and "
          f"the tail, {len(n_guided) // 2} guided calls ({len(n_guided)} UNet forwards), seed 7: "
          f"output std {p3std:.4f}; launches {p3_launches} (config 3a, no CFG: {sde_launches})")
    need(len(n_guided) == 2 * (2 * (n_sde - 1) + 1), f"config 3: {len(n_guided)} UNet forwards")
    need(b1_b6(p3_launches) == b1_b6(sde_launches)
         and p3_launches["B7"] == att4 * len(n_guided),
         "config 3: B2/B3 launches differ from config 3a's, or WCFG launched B1-B6")
    need(torch.equal(p3, config3_pipe(pair, noise=noise_3a())(x0, sigmas)),
         "config-3 pipeline not reproducible")

    torch.backends.cudnn.allow_tf32 = False
    cpu_model = copy.deepcopy(model).cpu()
    cpu_pair = eps_pair(cpu_model)
    c3_sig = bench_sigmas(torch, CONFIG3_STEPS)
    ngen = torch.Generator().manual_seed(18)
    c3_draws = [torch.randn(SHAPE, generator=ngen) for _ in range(2 * CONFIG3_STEPS)]
    on_card = config3_pipe(pair)(x0, c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i].to(dev))
    on_cpu = config3_pipe(cpu_pair)(x0.cpu(), c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i])
    err, rel = rel_err(on_card, on_cpu)
    print(f"[18] config-3 pipeline, {CONFIG3_STEPS - 1} steps and the tail on one injected "
          f"noise stream, card vs CPU, TF32 off: max abs diff {err:.3e}, max rel diff "
          f"{rel:.3e} (tolerance {TRAJ_TOL:g})")
    need(on_card.is_cuda and on_cpu.device.type == "cpu" and rel <= TRAJ_TOL,
         f"config-3 pipeline: card and CPU differ ({rel:.3e})")
    torch.backends.cudnn.allow_tf32 = True

    hp = config3_pipe(pair, noise=noise_3a())(x0.bfloat16(), short)
    fp = config3_pipe(pair, noise=noise_3a())(x0.bfloat16().float(), short)
    need(hp.dtype == torch.bfloat16 and bool(torch.isfinite(hp).all()),
         "config-3 pipeline, bfloat16 latent: malformed or not finite")
    err, rel = rel_err(hp.float(), fp)
    print(f"[18] config-3 pipeline, bfloat16 latent, {SHORT_STEPS - 1} steps and the tail: "
          f"against the float32 run from the same rounded start max abs diff {err:.3e}, max "
          f"rel diff {rel:.3e} (tolerance {BF16_TRAJ_TOL:g})")
    need(rel <= BF16_TRAJ_TOL, f"config-3 pipeline: bfloat16 and float32 runs differ {rel:.3e}")

    # -- phase 19: config 3 at its own size: SDXL-class UNet, 1x4x128x128, 30 steps ----
    print(f"[19] {time.perf_counter() - t_run:.0f} s into the run")
    sdxl_cfg = UNetConfig(model_channels=320, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                          attention_levels=(2, 3), num_heads=8, norm_groups=32)
    t0 = time.perf_counter()
    big = init_unet_params(torch.Generator().manual_seed(0), sdxl_cfg, device=dev)
    att19 = attention_blocks(big)
    n_par = sum(p_.numel() for p_ in big.parameters())
    print(f"[19] SDXL-class UNet (bench.py:552-558): {n_par / 1e6:.1f} M parameters, float32, "
          f"random weights from seed 0, made in {time.perf_counter() - t0:.1f} s")
    sx0 = (torch.randn(SDXL_SHAPE, generator=torch.Generator().manual_seed(2)) * 14.6).to(dev)
    bpair = eps_pair(big)
    n_fwd = []

    def sdxl_pipes(p):
        euler = SonarPipeline(model=p[0], model_uncond=p[1], sampler="sonar_euler",
                              sonar_config=SonarConfig(momentum=1.0), cfg_scale=7.0,
                              model_sampling=ms3, seed=7)
        return {"euler": lambda: euler(sx0, sdxl_sig),
                "config3": lambda: config3_pipe(p, noise=noise_3a())(sx0, sdxl_sig)}

    counted_runs = sdxl_pipes(counting(bpair))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_guided.clear()
    reset_counts()
    out3 = counted_runs["config3"]()
    l19 = read_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd3 = len(n_guided)
    n_guided.clear()
    outE = counted_runs["euler"]()
    torch.cuda.synchronize()
    fwdE = len(n_guided)
    for nm, o in (("config 3", out3), ("euler", outE)):
        need(o.shape == SDXL_SHAPE and o.is_cuda and bool(torch.isfinite(o).all()),
             f"SDXL {nm}: output malformed or not finite")
    sd_sched = _dpmpp_sde_schedule(sdxl_sig.tolist(), 1.0, 1.0, 0.5)
    n_in19 = sum(f32(0.3) <= st_ <= f32(14.7) for st_ in sd_sched["s_t"])
    want19 = {"B1": 0, "B2": 2 * SDXL_STEPS,
              "B3": 51 * n_in19 + 17 + 2 * (SDXL_STEPS - n_in19), "B4": 0, "B5": 0, "B6": 0,
              "B7": att19 * fwd3}
    print(f"[19] config 3 at {SDXL_SHAPE}, {SDXL_STEPS - 1} two-stage steps and the tail: "
          f"{fwd3 // 2} guided calls, {fwd3} UNet forwards; output std {float(out3.std()):.4f}; "
          f"launches {l19}; peak device memory {peak / 2**30:.2f} GiB; euler + basic CFG: "
          f"{fwdE // 2} guided calls, output std {float(outE.std()):.4f} [{card}]")
    need(fwd3 == 2 * (2 * (SDXL_STEPS - 1) + 1) and fwdE == 2 * SDXL_STEPS,
         f"SDXL: {fwd3} and {fwdE} UNet forwards")
    need(l19 == want19, f"SDXL config 3: expected launches {want19}")

    runs19 = sdxl_pipes(bpair)
    ms19 = {"euler": [], "config3": []}
    # 2 runs a side ([26] d times config 3 again, 2 runs a side in turns)
    for which in ("euler", "config3", "config3", "euler"):
        ms19[which].append(event_ms(torch, runs19[which]))
    per_call = {k: sorted(t / (SDXL_STEPS * (2 if k == "config3" else 1)) for t in v)
                for k, v in ms19.items()}

    def med(v):
        return (v[len(v) // 2] + v[(len(v) - 1) // 2]) / 2

    for k, v in per_call.items():
        print(f"[19] {k}: {med(v):.3f} ms per model call median (min {v[0]:.3f}, max "
              f"{v[-1]:.3f}; {len(v)} runs interleaved, run ms {[round(t, 1) for t in ms19[k]]}; "
              f"cudnn TF32 on, matmul TF32 off) [{card}]")
    overhead = 100.0 * (med(per_call["config3"]) / med(per_call["euler"]) - 1.0)
    print(f"[19] config3_overhead_pct {overhead:.2f} (config 3 over euler + basic CFG per "
          f"model call, medians) [{card}]")
    n19, by19 = profile_run(torch, runs19["config3"], "SDXL config 3")
    tot19 = sum(by19.values())
    wall19 = med(sorted(ms19["config3"])) * 1000
    top = sorted(by19.items(), key=lambda kv: -kv[1])[:8]
    print(f"[19] config-3 run under the profiler: {n19} device kernels, "
          f"{tot19:.1f} us of device time in {wall19:.1f} us wall (median run; busy "
          f"{100 * tot19 / wall19:.1f} %); B3 "
          f"{sum(v for n_, v in by19.items() if 'philox_fill' in n_):.1f} us, B2 "
          f"{sum(v for n_, v in by19.items() if 'scale_noise_' in n_):.1f} us [{card}]")
    for n_, v in top:
        print(f"[19]   {100 * v / tot19:5.1f} %  {v:10.1f} us  {n_[:110]}")
    # -- phase 20: FreeU-Extreme's spectral operators on the card --------------------
    print(f"[20] {time.perf_counter() - t_run:.0f} s into the run")
    frux_filter = PowerFilter(alpha=0.4)  # tools/bench_configs.py:65-67, filter_norm 0
    freeu_err = {op: 0.0 for op in FREEU_TOL}
    freeu_times = {}
    for hw in FREEU_HW:
        fx = torch.randn((1, FREEU_CH, hw, hw), generator=torch.Generator().manual_seed(hw))
        fx_cpu, fx = fx, fx.to(dev)
        on_cpu = ffilter(fx_cpu, frux_filter, 0.0, operator="fft")
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            outs = {op: ffilter(fx, frux_filter, 0.0, operator=op) for op in FREEU_TOL}
            torch.cuda.synchronize()
            need(all(o.is_cuda and o.shape == fx.shape and bool(torch.isfinite(o).all())
                     for o in outs.values()), f"FreeU {hw}x{hw}: an operator's output malformed")
            errs = {"fft": rel_err(outs["fft"], on_cpu)[1],
                    "dense": rel_err(outs["dense"], outs["fft"])[1],
                    "sep": rel_err(outs["sep"], outs["fft"])[1]}
            tols = dict(FREEU_TOL, dense=FREEU_TOL["dense"] if hw <= 32 else FREEU_DENSE_TOL_64)
            for op, e in errs.items():
                freeu_err[op] = max(freeu_err[op], e)
                need(e <= tols[op], f"FreeU {op} at {FREEU_CH}x{hw}x{hw}, TF32 "
                                    f"{'on' if tf32 else 'off'}: rel err {e:.3e}")
            print(f"[20] ffilter at 1x{FREEU_CH}x{hw}x{hw}, global TF32 {'on' if tf32 else 'off'}: "
                  f"dense vs fft {errs['dense']:.3e}, sep vs fft {errs['sep']:.3e}, card fft vs "
                  f"CPU fft {errs['fft']:.3e} (tolerances {tols})")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        row = {}
        for op in ("dense", "dense_fast", "sep", "fft"):
            fn = lambda op=op: ffilter(fx, frux_filter, 0.0, operator=op)  # noqa: E731
            ev = cuda_ms(torch, fn, 20) * 1000
            tot, _ = device_us(torch, fn, 10)
            need(tot is not None, f"FreeU {op} {hw}: device time not measured")
            row[op] = (tot, ev, device_us.launched)
        freeu_times[hw] = row
        print(f"[20] ffilter at 1x{FREEU_CH}x{hw}x{hw} (JAX's default: "
              f"{FU.default_operator(hw, hw)}; the port's: {FU.default_operator(hw, hw)}): "
              + ", ".join(f"{op} {t:.2f} us device ({n:.0f} kernels), {e:.1f} us by events"
                          for op, (t, e, n) in row.items()) + f" [{card}]")
        del fx, fx_cpu, on_cpu, outs
    def config4_patches(model_channels):
        """tools/bench_configs.py:65-70: FreeU on stage 1 of the input and
        output blocks, 3/4 of the channels, PowerFilter(alpha=0.4)."""
        frux = FreeUExtremeConfig(target="backbone", stage_1=True, scale=1.12, slice=0.75,
                                  sonar_power_filter=frux_filter)
        return make_freeu_patches(model_sampling=ms3, model_channels=model_channels,
                                  input_config=frux, output_config=frux)

    # one stage-1 patch as config 4 runs it (hidden-mean scale, slice, filter,
    # window select), at 32x32
    p4 = config4_patches(sdxl_cfg.model_channels)
    ph = torch.randn((1, 1280, 32, 32), device=dev)
    pfn = lambda: p4["input"][0](ph, {"sigma": torch.full((1,), 5.0, device=dev)})  # noqa: E731
    p_ev = cuda_ms(torch, pfn, 20) * 1000
    p_tot, _ = device_us(torch, pfn, 10)
    print(f"[20] one config-4 input patch at 1x1280x32x32: {device_us.launched:.0f} device "
          f"kernels, {fmt_us(p_tot)} device, {p_ev:.1f} us by events [{card}]")
    # one patched forward of the SDXL-class UNet reads nothing back from the card
    patches4 = config4_patches(sdxl_cfg.model_channels)
    filtered = []

    def counted_ffilter(x, *a, **kw):
        filtered.append(x.shape[-1])
        return ffilter(x, *a, **kw)

    s_in = torch.full((1,), 5.0, device=dev)
    with torch.no_grad(), patched(FU, ffilter=counted_ffilter):
        big(sx0, s_in, block_patches=patches4)  # the first call puts the operators on the card
    torch.cuda.synchronize()
    n_filtered = {hw: filtered.count(hw) for hw in sorted(set(filtered))}
    need(n_filtered == CONFIG4_PATCHES, f"config 4: filtered activations {n_filtered}, "
                                        f"expected {CONFIG4_PATCHES} a cond forward")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            pout = big(sx0, s_in, block_patches=patches4)
    except RuntimeError as e:
        fail(f"a patched forward synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with torch.no_grad():
        plain_out = big(sx0, s_in)
    need(bool(torch.isfinite(pout).all()) and not torch.equal(pout, plain_out),
         "patched forward: not finite, or equal to the plain forward")
    print(f"[20] one patched forward of the SDXL-class UNet at {SDXL_SHAPE}, sigma 5: stage-1 "
          f"activations filtered by size {n_filtered} (dense K at 16 and 32, FFT at 64), under "
          f"torch.cuda.set_sync_debug_mode('error'): no synchronisation")
    del ph, pout, plain_out

    # -- phase 21: configs 4 and 2 at their own size ------------------------------------
    print(f"[21] {time.perf_counter() - t_run:.0f} s into the run")

    def config4_pipe(p):
        """tools/bench_configs.py:52-96: sonar_euler, momentum 0.95, per-band and
        per-orientation wavelet CFG; FreeU on the cond UNet (in ``p``)."""
        rules = WCFGRules.build(
            wave="db4", level=3, padding_mode="periodization", high_precision_mode=False,
            diff=dict(yl_scale=8.0, yh_scales=[[7.0, 6.5, 7.5], [6.0, 6.0, 7.0], "fill"],
                      scales_end=dict(yl_scale=6.0, yh_scales=6.0), schedule="half_cosine",
                      schedule_mode="sampling"))
        return SonarPipeline(model=p[0], model_uncond=p[1], sampler="sonar_euler",
                             sonar_config=SonarConfig(momentum=0.95), cfg_scale=7.0,
                             wavelet_cfg=WaveletCFG(rules=rules), model_sampling=ms3, seed=7)

    def config2_pipe(p, **kw):
        """tools/bench_configs.py:33-49: sonar_euler_ancestral, momentum 0.95, a
        NoiseChain of perlin (0.6) and onef_pinkish (0.4), CFG 7."""
        kw.setdefault("noise", NoiseChain([get_noise_item("perlin", factor=0.6),
                                           get_noise_item("onef_pinkish", factor=0.4)]))
        return SonarPipeline(model=p[0], model_uncond=p[1], sampler="sonar_euler_ancestral",
                             sonar_config=SonarConfig(momentum=0.95), cfg_scale=7.0,
                             model_sampling=ms3, seed=7, **kw)

    bpair4 = eps_pair(big, patches4)
    runs21 = {"euler": runs19["euler"],
              "config4": lambda: config4_pipe(bpair4)(sx0, sdxl_sig),
              "config2": lambda: config2_pipe(bpair)(sx0, sdxl_sig)}
    counted21 = {"config4": lambda: config4_pipe(counting(bpair4))(sx0, sdxl_sig),
                 "config2": lambda: config2_pipe(counting(bpair))(sx0, sdxl_sig)}
    l21, peak21, out21 = {}, {}, {}
    for k, fn in counted21.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_guided.clear()
        reset_counts()
        out21[k] = fn()
        l21[k] = read_counts()
        peak21[k] = torch.cuda.max_memory_allocated()
        o = out21[k]
        need(o.shape == SDXL_SHAPE and o.is_cuda and bool(torch.isfinite(o).all()),
             f"SDXL {k}: output malformed or not finite")
        need(len(n_guided) == 2 * SDXL_STEPS, f"SDXL {k}: {len(n_guided)} UNet forwards")
        need(torch.equal(o, runs21[k]()), f"SDXL {k}: not reproducible")
        print(f"[21] {k} at {SDXL_SHAPE}, {SDXL_STEPS} steps: {len(n_guided) // 2} guided calls, "
              f"output std {float(o.std()):.4f}; launches {l21[k]}; peak device memory "
              f"{peak21[k] / 2**30:.2f} GiB [{card}]")
    # config 2 draws once a step: perlin's base and two angle fields and
    # onef's gaussian (B3 four times), one scale_noise at the chain (B2), and
    # the fused momentum step (B1); config 4 draws nothing and launches none
    want21 = {"config4": {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B6": 0,
                          "B7": att19 * 2 * SDXL_STEPS},
              "config2": {"B1": SDXL_STEPS, "B2": SDXL_STEPS, "B3": 4 * SDXL_STEPS, "B4": 0,
                          "B5": 0, "B6": 0, "B7": att19 * 2 * SDXL_STEPS}}
    need(l21 == want21, f"SDXL configs 4 and 2: expected launches {want21}")
    need(not torch.equal(out21["config4"], config4_pipe(bpair)(sx0, sdxl_sig)),
         "config 4: the FreeU patches changed nothing")

    ms21 = {k: [] for k in runs21}
    # 2 runs a side (4 until [26] needed the room)
    for which in ("euler", "config4", "config2", "config2", "config4", "euler"):
        ms21[which].append(event_ms(torch, runs21[which]))
    per21 = {k: sorted(t / SDXL_STEPS for t in v) for k, v in ms21.items()}
    for k, v in per21.items():
        print(f"[21] {k}: {med(v):.3f} ms per model call median (min {v[0]:.3f}, max "
              f"{v[-1]:.3f}; {len(v)} runs interleaved, run ms {[round(t, 1) for t in ms21[k]]}; "
              f"cudnn TF32 on, matmul TF32 off) [{card}]")
    for k in ("config4", "config2"):
        pct = [100.0 * (t / med(per21["euler"]) - 1.0) for t in per21[k]]
        print(f"[21] {k}_overhead_pct {100.0 * (med(per21[k]) / med(per21['euler']) - 1.0):.2f} "
              f"(over euler + basic CFG per model call, medians; its runs against the euler "
              f"median: min {pct[0]:.2f}, max {pct[-1]:.2f}) [{card}]")
    parts = {"B1": "momentum_step_kernel", "B2": "scale_noise_", "B3": "philox_fill",
             "FFT": "fft", "GEMM": "gemm"}
    n21 = {}
    for k in runs21:
        n21[k], by21 = profile_run(torch, runs21[k], f"SDXL {k}")
        tot21 = sum(by21.values())
        wall21 = med(sorted(ms21[k])) * 1000
        got21 = {p_: sum(v for n_, v in by21.items() if pat in n_.lower())
                 for p_, pat in parts.items()}
        print(f"[21] {k} run under the profiler: {n21[k]} device kernels "
              f"({(n21[k] - n21['euler']) / SDXL_STEPS:+.1f} a guided call against euler), "
              f"{tot21:.1f} us of device time in {wall21:.1f} us wall (median run; busy "
              f"{100 * tot21 / wall21:.1f} %); "
              f"{', '.join(f'{p_} {v:.1f} us' for p_, v in got21.items())} [{card}]")

    # card against CPU on the flagship at 1x4x64x64, a few steps, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    fl4 = config4_patches(cfg.model_channels)  # its operators are kept per device
    for k, make, fp in (("config4", config4_pipe, fl4),
                        ("config2", lambda p: config2_pipe(p, noise=None), None)):
        on_card = make(eps_pair(model, fp))(
            x0, c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i].to(dev))
        on_cpu = make(eps_pair(cpu_model, fp))(
            x0.cpu(), c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i])
        err, rel = rel_err(on_card, on_cpu)
        print(f"[21] {k} on the flagship at {SHAPE}, {CONFIG3_STEPS - 1} steps and the tail on "
              f"one injected noise stream, card vs CPU, TF32 off: max abs diff {err:.3e}, max "
              f"rel diff {rel:.3e} (tolerance {TRAJ_TOL:g})")
        need(on_card.is_cuda and rel <= TRAJ_TOL, f"{k}: card and CPU differ ({rel:.3e})")
    torch.backends.cudnn.allow_tf32 = True

    # -- phase 22: config 5, 16-frame video noise ----------------------------------------
    print(f"[22] {time.perf_counter() - t_run:.0f} s into the run")

    def video_sampler(where):
        """tools/bench_configs.py:129-140: time-brownian power noise with the
        frames folded into channels."""
        item = CustomNoiseParametersNoise(
            noise=PowerNoiseItem(alpha=0.5, min_freq=0.05, time_brownian=True),
            frames_to_channels=True)
        return make_noise_sampler(item, VIDEO_SHAPE, device=where, seed=3, sigma_min=0.03,
                                  sigma_max=14.6)

    vfn, vst = video_sampler(dev)
    reset_counts()
    vnoise, _ = vfn(vst, 1.0, 0.9)
    l22 = read_counts()
    need(vnoise.shape == VIDEO_SHAPE and vnoise.is_cuda and bool(torch.isfinite(vnoise).all()),
         "video noise: malformed or not finite")
    band = 2.5 / math.sqrt(vnoise.numel())  # scale_noise's dead band
    need(abs(float(vnoise.mean())) <= band and abs(float(vnoise.std()) - 1.0) <= band,
         "video noise: not normalized")
    # W at both ends (no cache hit: 17 B3 launches each), one scale_noise
    want22 = {"B1": 0, "B2": 1, "B3": 34, "B4": 0, "B5": 0, "B6": 0, "B7": 0}
    need(l22 == want22, f"video noise: launches {l22}, expected {want22}")

    def video_draws():
        st = vst
        for _ in range(VIDEO_DRAWS):
            _, st = vfn(st, 1.0, 0.9)

    vms = sorted(cuda_ms(torch, video_draws, 1) for _ in range(4))
    mpix = [math.prod(VIDEO_SHAPE) * VIDEO_DRAWS / (t / 1000.0) / 1e6 for t in vms]
    v_tot, _ = device_us(torch, lambda: vfn(vst, 1.0, 0.9), 5)
    need(v_tot is not None, "video noise: device time not measured")
    print(f"[22] video_noise_mpix_per_sec at {VIDEO_SHAPE}, {VIDEO_DRAWS} draws a run: "
          f"{[round(m, 2) for m in sorted(mpix)]} over 4 runs (median "
          f"{(sorted(mpix)[1] + sorted(mpix)[2]) / 2:.2f}); one draw {device_us.launched:.0f} "
          f"device kernels, {v_tot:.1f} us device, launches {l22} [{card}]")
    cfn, cst = video_sampler("cpu")
    gfn, gst = video_sampler(dev)
    worst = 0.0
    for s_, sn_ in ((14.0, 9.0), (9.0, 4.0)):  # a miss, then a cache hit
        a, cst = cfn(cst, s_, sn_)
        b, gst = gfn(gst, s_, sn_)
        worst = max(worst, rel_err(b, a)[1])
    print(f"[22] video noise, seed 3, two draws, CPU (plain) vs card (kernels): max rel diff "
          f"{worst:.3e} (tolerance {XDEV_TOL:g})")
    need(worst <= XDEV_TOL, f"video noise: CPU and card differ ({worst:.3e})")
    del vnoise

    # -- phase 23: the sampler registry on the flagship, at full width -------------------
    print(f"[23] {time.perf_counter() - t_run:.0f} s into the run")
    import inspect

    import numpy as np

    from sonar_tpu_torch.api import get_sampler, sampler_config_override
    from sonar_tpu_torch.api.functions import SAMPLERS as REGISTRY

    # at REG_STEPS steps, to leave room for [25] and [31] (depth, not width)
    reg_sig = bench_sigmas(torch, REG_STEPS)
    need(len(REGISTRY) == 31, f"the registry holds {len(REGISTRY)} names, not 31")
    first_name = {}
    for nm in sorted(REGISTRY):
        first_name.setdefault(id(REGISTRY[nm]), nm)
    sweep = [nm for nm in sorted(REGISTRY) if first_name[id(REGISTRY[nm])] == nm]
    aliases = sorted(set(REGISTRY) - set(sweep))
    need(len(sweep) == 28 and all(a.endswith("_gpu") and get_sampler(a) is get_sampler(a[:-4])
                                  for a in aliases), f"registry aliases: {aliases}")

    class Recorded:
        """The denoiser, counting its calls and recording each call's host
        sigma (the samplers pass it beside the batch, so recording reads
        nothing back); with ``sync_check`` it turns on the sync check at its
        first call, after the sampler's set-up."""

        takes_sigma_host = True

        def __init__(self, fn, sync_check=False):
            self.fn, self.sigmas, self.sync_check = fn, [], sync_check

        def __call__(self, xi, s_in, *, sigma_host=None, **kw):
            if self.sync_check and not self.sigmas:
                torch.cuda.set_sync_debug_mode("error")
            self.sigmas.append(sigma_host)
            return self.fn(xi, s_in, **kw)

    # draws a run at REG_STEPS steps and a final 0 (every step but the tail:
    # sigma_down or sigma_next is 0 there; restart: its two jumps, B3 alone)
    n_draws = {"euler_ancestral": REG_STEPS, "dpmpp_2s_ancestral": REG_STEPS,
               "lcm": REG_STEPS,
               "sonar_euler_ancestral": REG_STEPS, "dpm_2_ancestral": REG_STEPS - 1,
               "ddpm": REG_STEPS - 1, "res_multistep_ancestral": REG_STEPS - 1, "restart": 0}
    brownian = {"dpmpp_sde": 2 * REG_STEPS, "sonar_dpmpp_sde": 2 * REG_STEPS,
                "dpmpp_2m_sde": REG_STEPS, "dpmpp_3m_sde": REG_STEPS}
    reg = {}
    reg_launches = {k: 0 for k in counters}
    print(f"[23] {len(sweep)} samplers ({len(REGISTRY)} names; {', '.join(aliases)} are the "
          f"same functions), {cfg} {SHAPE}, {REG_STEPS} Karras steps 14.6 -> 0.03 and 0, "
          f"seed 7; "
          f"3 timed runs each after one counted run under the sync check [{card}]")
    for nm in sweep:
        fn = REGISTRY[nm]
        rec = Recorded(denoiser, sync_check=nm != "dpm_adaptive")
        reset_counts()
        try:
            so = fn(rec, x0, reg_sig, seed=7)
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"[23] {nm}: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lr = read_counts()
        for k in counters:
            reg_launches[k] += lr[k]
        need(so.is_cuda and so.shape == SHAPE and so.dtype == torch.float32
             and bool(torch.isfinite(so).all()), f"[23] {nm}: output malformed or not finite")
        want_b2 = n_draws.get(nm, brownian.get(nm, 0))
        want = {"B1": REG_STEPS if nm == "sonar_euler_ancestral" else 0, "B2": want_b2,
                "B4": 0, "B5": 0, "B6": 0, "B7": att4 * len(rec.sigmas)}
        if nm not in brownian:
            want["B3"] = 2 if nm == "restart" else want_b2
        need(all(lr[k] == v for k, v in want.items()) and (nm not in brownian or lr["B3"] > 0),
             f"[23] {nm}: launches {lr}, expected {want}")
        runs = sorted(event_ms(torch, lambda: fn(denoiser, x0, reg_sig, seed=7)) for _ in range(3))
        nk, by = profile_run(torch, lambda: fn(denoiser, x0, reg_sig, seed=7), f"[23] {nm}")
        dev_us = sum(by.values())
        reg[nm] = {"steps_per_s": REG_STEPS / (runs[1] / 1000.0), "run_ms": runs,
                   "model_calls": len(rec.sigmas), "B2": lr["B2"], "B3": lr["B3"],
                   "device_kernels": nk, "device_us": dev_us,
                   "busy_pct": 100.0 * dev_us / (runs[1] * 1000.0)}
        if nm == "dpm_adaptive":
            reg[nm]["attempts"] = len(rec.sigmas) // 3
            reg[nm]["accepted"] = len(set(rec.sigmas[::3]))
        r_ = reg[nm]
        print(f"[23] {nm:>24}: {r_['steps_per_s']:8.2f} steps/s (median of "
              f"{[round(t, 2) for t in runs]} ms), {r_['model_calls']:3d} model calls, B2 "
              f"{lr['B2']:3d}, B3 {lr['B3']:4d}, {nk} device kernels, {dev_us:.1f} us device, busy "
              f"{r_['busy_pct']:.1f} %"
              + (f"; {r_['attempts']} attempts, {r_['accepted']} accepted" if "attempts" in r_
                 else "") + f" [{card}]")
    print(json.dumps({"registry": reg}))

    # one override: a k-diffusion sampler handed pyramid noise launches B4
    over = sampler_config_override(get_sampler("dpmpp_2s_ancestral"),
                                   noise_item=get_noise_item("pyramid"))
    reset_counts()
    po = over(denoiser, x0, reg_sig, seed=7)
    lo = read_counts()
    for k in counters:
        reg_launches[k] += lo[k]
    need(po.shape == SHAPE and bool(torch.isfinite(po).all()), "[23] override: not finite")
    need(lo["B4"] == REG_STEPS and lo["B2"] == REG_STEPS and lo["B3"] > 0 and lo["B1"] == 0
         and lo["B7"] > 0 and lo["B7"] % att4 == 0,
         f"[23] override with pyramid noise: launches {lo}")
    print(f"[23] sampler_config_override(dpmpp_2s_ancestral, noise_item=pyramid): launches {lo}")

    # the card against the CPU on one injected numpy stream (restart: one
    # seed's Philox jumps, the same on both), TF32 off, at CONFIG3_STEPS steps;
    # dpm_adaptive with a tight controller, so that it rejects attempts
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(23)
    np_draws = [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
                for _ in range(2 * CONFIG3_STEPS)]
    card_draws = [d.to(dev) for d in np_draws]
    cpu_den = make_denoiser(cpu_model)
    xerr = {}
    t0 = time.perf_counter()
    for nm in sweep:
        fn = REGISTRY[nm]
        takes = "noise_sampler" in inspect.signature(fn).parameters
        res = {}
        for where, den, dr in ((dev, denoiser, card_draws), ("cpu", cpu_den, np_draws)):
            kw = {"noise_sampler": (lambda i, s, sn, _d=dr: _d[i])} if takes else {}
            if nm == "dpm_adaptive":
                kw.update(h_init=2.0, rtol=1e-4, atol=1e-5)
            rec = Recorded(den)
            res[str(where)] = fn(rec, x0.to(where), c3_sig, seed=7, **kw), rec.sigmas
        (co, cs), (po_, ps) = res[str(dev)], res["cpu"]
        need(co.is_cuda and po_.device.type == "cpu" and len(cs) == len(ps),
             f"[23] {nm}: card and CPU made {len(cs)} and {len(ps)} model calls")
        if nm == "dpm_adaptive":
            need(len(set(cs[::3])) == len(set(ps[::3])),
                 f"[23] dpm_adaptive: {len(set(cs[::3]))} accepted steps on the card, "
                 f"{len(set(ps[::3]))} on the CPU")
            print(f"[23] dpm_adaptive at {CONFIG3_STEPS} steps: {len(cs) // 3} attempts, "
                  f"{len(set(cs[::3]))} accepted, on the card and on the CPU alike")
        xerr[nm] = rel_err(co, po_)[1]
    torch.backends.cudnn.allow_tf32 = True
    worst_nm = max(xerr, key=xerr.get)
    print(f"[23] card vs CPU, {CONFIG3_STEPS} Karras steps on one injected numpy stream, TF32 "
          f"off, {cfg} at full width: max rel diff {xerr[worst_nm]:.3e} ({worst_nm}; tolerance "
          f"{TRAJ_TOL:g}) in {time.perf_counter() - t0:.0f} s; "
          f"{ {k: float(f'{v:.2e}') for k, v in xerr.items()} }")
    need(xerr[worst_nm] <= TRAJ_TOL, f"[23] {worst_nm}: card and CPU differ ({xerr[worst_nm]:.3e})")

    # -- phase 24: two registry samplers on the SDXL-class UNet, with CFG ----------------
    print(f"[24] {time.perf_counter() - t_run:.0f} s into the run")

    def reg_pipe(p, nm):
        return SonarPipeline(model=p[0], model_uncond=p[1], sampler=nm, cfg_scale=7.0,
                             model_sampling=ms3, seed=7)

    names24 = ("dpmpp_2m_sde_gpu", "dpmpp_2s_ancestral")
    runs24 = {"euler": runs19["euler"],
              **{nm: (lambda _nm=nm: reg_pipe(bpair, _nm)(sx0, sdxl_sig)) for nm in names24}}
    l24, peak24, calls24, fwd24 = {}, {}, {"euler": SDXL_STEPS}, {}
    for nm in names24:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_guided.clear()
        reset_counts()
        o = reg_pipe(counting(bpair), nm)(sx0, sdxl_sig)
        l24[nm] = read_counts()
        peak24[nm] = torch.cuda.max_memory_allocated()
        calls24[nm] = len(n_guided) // 2
        fwd24[nm] = len(n_guided)
        need(o.shape == SDXL_SHAPE and o.is_cuda and bool(torch.isfinite(o).all()),
             f"SDXL {nm}: output malformed or not finite")
        print(f"[24] {nm} + basic CFG 7 at {SDXL_SHAPE}, {SDXL_STEPS} steps: {calls24[nm]} "
              f"guided calls, output std {float(o.std()):.4f}; launches {l24[nm]}; peak device "
              f"memory {peak24[nm] / 2**30:.2f} GiB [{card}]")
    need(calls24["dpmpp_2m_sde_gpu"] == SDXL_STEPS
         and calls24["dpmpp_2s_ancestral"] == 2 * SDXL_STEPS - 1,
         f"[24] guided calls {calls24}")
    # one draw a step, the tail too: B2 once a draw; the Brownian W
    # evaluations launch B3 17 times each, the gaussian once a draw
    need(l24["dpmpp_2s_ancestral"] == {"B1": 0, "B2": SDXL_STEPS, "B3": SDXL_STEPS, "B4": 0,
                                       "B5": 0, "B6": 0,
                                       "B7": att19 * fwd24["dpmpp_2s_ancestral"]}
         and l24["dpmpp_2m_sde_gpu"]["B7"] == att19 * fwd24["dpmpp_2m_sde_gpu"]
         and l24["dpmpp_2m_sde_gpu"]["B2"] == SDXL_STEPS
         and l24["dpmpp_2m_sde_gpu"]["B3"] >= 17 * SDXL_STEPS
         and all(l24["dpmpp_2m_sde_gpu"][k] == 0 for k in ("B1", "B4", "B5", "B6")),
         f"[24] launches {l24}")
    ms24 = {k: [] for k in runs24}
    for which in ("euler", names24[0], names24[1], names24[1], names24[0], "euler"):
        ms24[which].append(event_ms(torch, runs24[which]))
    per24 = {k: sorted(t / calls24[k] for t in v) for k, v in ms24.items()}
    for k, v in per24.items():
        print(f"[24] {k}: {med(v):.3f} ms per model call median (min {v[0]:.3f}, max {v[-1]:.3f}; "
              f"{len(v)} runs interleaved, run ms {[round(t, 1) for t in ms24[k]]}; cudnn TF32 "
              f"on, matmul TF32 off) [{card}]")
    for nm in names24:
        pct = 100.0 * (med(per24[nm]) / med(per24["euler"]) - 1.0)
        n24, by24 = profile_run(torch, runs24[nm], f"SDXL {nm}")
        tot24 = sum(by24.values())
        print(f"[24] {nm}: {pct:.2f} % per model call over euler + basic CFG (medians); under "
              f"the profiler {n24} device kernels ({n24 / calls24[nm]:.1f} a guided call), "
              f"{tot24:.1f} us of device time in {med(sorted(ms24[nm])) * 1000:.1f} us wall "
              f"(busy {100 * tot24 / (med(sorted(ms24[nm])) * 1000):.1f} %); B2 "
              f"{sum(v for n_, v in by24.items() if 'scale_noise_' in n_):.1f} us, B3 "
              f"{sum(v for n_, v in by24.items() if 'philox_fill' in n_):.1f} us [{card}]")
    keep21 = {"out": out21["config2"], "run": runs21["config2"]}  # [27] (a) is held to them
    del bpair4, runs19, runs21, runs24, counted_runs, out3, outE, out21  # [26] d uses big
    print(f"[24] phases 1-24 took {time.perf_counter() - t_run:.0f} s (the kernels' build "
          f"{build_s:.0f} s of it)")

    # -- phase 25: the combinator algebra: config 5's z-walk and three trees -------------
    print(f"[25] {time.perf_counter() - t_run:.0f} s into the run")
    from sonar_tpu_torch.cfg.latent_ops import SonarLatentOperationQuantileFilter
    from sonar_tpu_torch.noise import (BlehOpsNoise, BlendedNoise, BlendFilterNoise, ChannelNoise,
                                       CompositeNoise, GuidedNoise, LatentOperationFilteredNoise,
                                       ModulatedNoise, MultiChildNoise, NoiseItem,
                                       NormalizeToScaleNoise, PatternBreakNoise, PerDimNoise,
                                       QuantileFilteredNoise, RandomNoise, RepeatedNoise,
                                       ResizedNoise, RippleFilteredNoise, ShuffledNoise,
                                       WaveletFilteredNoise, WaveletGenerator)

    # (a) config 5's Voronoi z-walk cell (tools/bench_configs.py:143-157)
    def zwalk_sampler(where):
        inner = VoronoiGenerator(n_points=(32,), z_increment=ZWALK_Z_INCREMENT, z_range=10.0,
                                 result_mode=("f1",))
        item = PerDimNoise(noise=CustomNoiseParametersNoise(noise=inner, frames_to_channels=True,
                                                            normalize=False),
                           dim=2, chunk_size=1, normalize=False)
        return make_noise_sampler(item, VIDEO_SHAPE, device=where, seed=3)

    def zwalk_z(st):
        return float(st["node"]["noise"]["noise"]["z"])

    frames = VIDEO_SHAPE[2]
    zfn, zst = zwalk_sampler(dev)
    reset_counts()
    znoise, zst1 = zfn(zst, 1.0, 0.9)
    lz = read_counts()
    need(znoise.shape == VIDEO_SHAPE and znoise.is_cuda and bool(torch.isfinite(znoise).all()),
         "z-walk: malformed or not finite")
    # a frame a chunk: B6 once (k = 1, f1) and the reset mode's fresh feature
    # points (B3) once; nothing normalizes
    want_z = {"B1": 0, "B2": 0, "B3": frames, "B4": 0, "B5": 0, "B6": frames, "B7": 0}
    need(lz == want_z, f"z-walk: launches {lz}, expected {want_z}")
    dz = zwalk_z(zst1) - zwalk_z(zst)
    need(abs(dz - frames * ZWALK_Z_INCREMENT) <= 1e-4,
         f"z-walk: z moved {dz} in a draw, not {frames} x {ZWALK_Z_INCREMENT}")

    def zwalk_draws():
        st = zst
        for _ in range(ZWALK_DRAWS):
            _, st = zfn(st, 1.0, 0.9)

    zms = sorted(cuda_ms(torch, zwalk_draws, 1) for _ in range(4))
    zmpix = sorted(math.prod(VIDEO_SHAPE) * ZWALK_DRAWS / (t / 1000.0) / 1e6 for t in zms)
    z_tot, z_by = device_us(torch, lambda: zfn(zst, 1.0, 0.9), 3)
    need(z_tot is not None, "z-walk: device time not measured")
    z_b6 = sum(v for n_, v in z_by.items() if "voronoi_ksmallest_kernel" in n_)
    print(f"[25] voronoi_zwalk_mpix_per_sec at {VIDEO_SHAPE}, {ZWALK_DRAWS} draws a run: median "
          f"{(zmpix[1] + zmpix[2]) / 2:.2f} (min {zmpix[0]:.2f}, max {zmpix[-1]:.2f}, 4 runs); one "
          f"draw {device_us.launched:.0f} device kernels, {z_tot:.1f} us device (B6 {z_b6:.1f} "
          f"us), {zms[1] / ZWALK_DRAWS * 1000:.1f} us wall; z moved {dz:.5f}; launches {lz} "
          f"[{card}]")
    cfn, cst = zwalk_sampler("cpu")
    gfn, gst = zwalk_sampler(dev)
    worst = 0.0
    for _ in range(2):
        a, cst = cfn(cst, 1.0, 0.9)
        b, gst = gfn(gst, 1.0, 0.9)
        worst = max(worst, rel_err(b, a)[1])
    print(f"[25] z-walk, seed 3, two draws, CPU (plain) vs card (kernels): max rel diff "
          f"{worst:.3e} (tolerance {XDEV_TOL:g})")
    need(worst <= XDEV_TOL, f"z-walk: CPU and card differ ({worst:.3e})")
    del znoise, zst1, a, b

    # (b) three combinator trees under sample_sonar_euler_ancestral, flagship, 20 steps
    g = get_noise_item
    mask_a = np.zeros(SHAPE[-2:], np.float32)
    mask_a[:, : SHAPE[-1] // 2] = 1.0  # left half src, right half dst
    guide_c = np.random.default_rng(11).standard_normal((1, 4, 32, 32)).astype(np.float32)
    rules_b = [{"when": {"sigma_min": 0.5, "sigma_max": 10.0},
                "ops": [["ffilter", {"filter": "highpass", "threshold": 0.1, "scale": 0.5,
                                     "strength": 0.6}],
                        ["enhance", {"mode": "sharpen", "scale": 0.3}],
                        ["roll", {"dim": -1, "amount": 5}]]}]
    qfilter_c = SonarLatentOperationQuantileFilter(quantile=0.9, strategy="tanh", start_sigma=5.0)
    trees = {
        "A": CompositeNoise(
            mask=mask_a,
            dst_noise=RepeatedNoise(noise=g("pyramid"), repeat_length=4, max_recycle=2),
            src_noise=ModulatedNoise(noise=ChannelNoise(noise=[
                g("gaussian"), g("perlin"), g("highres_pyramid"), g("voronoi_mix")]),
                modulation_type="intensity")),
        "B": PatternBreakNoise(noise=ShuffledNoise(noise=QuantileFilteredNoise(
            noise=NormalizeToScaleNoise(mode="advanced", noise=BlehOpsNoise(
                rules=rules_b, noise=BlendFilterNoise(noise=[
                    RippleFilteredNoise(noise=g("gaussian")),
                    WaveletFilteredNoise(noise=g("gaussian"), noise_high=g("onef_pinkish"),
                                         wave="db4", level=3),
                    g("wavelet")], ffilter="highpass", enhance_mode="sharpen",
                    affect="both")))))),
        "C": BlendedNoise(
            custom_noise_mask=g("perlin"),
            custom_noise_1=GuidedNoise(ref_latent=guide_c, method="euler", noise=RandomNoise(
                mix_count=2, noise=[
                    ResizedNoise(custom_noise=g("gaussian"), width=256, height=256),
                    PerDimNoise(noise=g("pyramid"), dim=1),
                    LatentOperationFilteredNoise(noise=g("gaussian"), operations=[qfilter_c])])),
            custom_noise_2=g("gaussian")),
    }

    def nodes(v):
        if isinstance(v, NoiseItem):
            yield v
            v = list(v.params().values())
        if isinstance(v, (list, tuple)):
            for x in v:
                yield from nodes(x)

    used = [n for t in trees.values() for n in nodes(t)]
    for cls in (CompositeNoise, GuidedNoise, RepeatedNoise, ModulatedNoise, MultiChildNoise,
                RandomNoise, ChannelNoise, RippleFilteredNoise, NormalizeToScaleNoise,
                BlendedNoise, ResizedNoise, LatentOperationFilteredNoise, QuantileFilteredNoise,
                PerDimNoise, ShuffledNoise, PatternBreakNoise, BlendFilterNoise, BlehOpsNoise,
                WaveletFilteredNoise, WaveletGenerator):
        need(any(isinstance(n, cls) for n in used), f"[25] no tree holds a {cls.__name__}")

    def run_item(item, den=None, x=None, sig=None):
        return sample_sonar_euler_ancestral(den or denoiser, x0 if x is None else x,
                                            sigmas if sig is None else sig, seed=7,
                                            noise_item=item)

    def run_tree(k, **kw):
        return run_item(trees[k], **kw)

    l25 = {}
    print(f"[25] trees A (composite), B (filters), C (guided) under sonar_euler_ancestral, "
          f"{cfg} {SHAPE}, {STEPS} Karras steps 14.6 -> 0.03 and 0, seed 7 [{card}]")
    for k in "ABC":
        rec = Recorded(denoiser)
        reset_counts()
        o = run_tree(k, den=rec)
        l25[k] = read_counts()
        need(o.is_cuda and o.shape == SHAPE and bool(torch.isfinite(o).all()),
             f"[25] tree {k}: output malformed or not finite")
        need(len(rec.sigmas) == STEPS, f"[25] tree {k}: {len(rec.sigmas)} model calls")
        want25 = {**TREE_LAUNCHES[k], "B7": att4 * STEPS}
        need(l25[k] == want25, f"[25] tree {k}: launches {l25[k]}, expected {want25}")
        need(torch.equal(o, run_tree(k)), f"[25] tree {k} is not reproducible for one seed")
        # no host synchronisation inside a step (the first run put the
        # resize matrices, filter gains and DWT taps on the card)
        rec = Recorded(denoiser, sync_check=True)
        try:
            run_tree(k, den=rec)
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"[25] tree {k} synchronised inside a step: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"[25] tree {k}: {len(rec.sigmas)} model calls, output std {float(o.std()):.4f}; "
              f"launches {l25[k]}; {STEPS} steps under set_sync_debug_mode('error'): no sync")
    need(all(v > 0 for v in l25["A"].values()), f"[25] tree A launched {l25['A']}")

    runs25 = {"gaussian": headline, **{k: (lambda _k=k: run_tree(_k)) for k in "ABC"}}
    ms25 = {k: [] for k in runs25}
    for _ in range(3):
        for k, fn in runs25.items():
            ms25[k].append(event_ms(torch, fn))
    tree_stats = {}
    for k, fn in runs25.items():
        v = sorted(ms25[k])
        n25, by25 = profile_run(torch, fn, f"[25] {k}")
        dev25 = sum(by25.values())
        tree_stats[k] = {"steps_per_s": STEPS / (v[1] / 1000.0), "run_ms": v,
                         "device_kernels": n25, "device_us": dev25,
                         "busy_pct": 100.0 * dev25 / (v[1] * 1000.0)}
        print(f"[25] {k}: {tree_stats[k]['steps_per_s']:.2f} steps/s (median of "
              f"{[round(t, 2) for t in v]} ms, in turns with the others), {n25} device "
              f"kernels, {dev25:.1f} us device, busy {tree_stats[k]['busy_pct']:.1f} % [{card}]")
    print(json.dumps({"trees": tree_stats, "voronoi_zwalk_mpix_per_sec": zmpix}))

    # the card against the CPU at CONFIG3_STEPS steps, one seed, TF32 off.
    # pattern_break hashes its input's sixth decimal (remainder(|x|·1e6, 11)),
    # so the ulps by which the card's FFTs and sums differ from the CPU's come
    # out of it as unrelated values: tree B is held without its outer
    # PatternBreakNoise, and pattern_break alone on one input on both
    torch.backends.cudnn.allow_tf32 = False
    held = {"A": trees["A"], "B without its PatternBreakNoise": trees["B"].noise,
            "C": trees["C"]}
    for k, item in held.items():
        a = run_item(item, den=cpu_den, x=x0.cpu(), sig=c3_sig)
        b = run_item(item, sig=c3_sig)
        rel = rel_err(b, a)[1]
        print(f"[25] tree {k}, {CONFIG3_STEPS} steps, seed 7, card vs CPU, TF32 off: max rel "
              f"diff {rel:.3e} (tolerance {TRAJ_TOL:g})")
        need(b.is_cuda and a.device.type == "cpu" and rel <= TRAJ_TOL,
             f"[25] tree {k}: card and CPU differ ({rel:.3e})")
    whole = rel_err(run_tree("B", sig=c3_sig), run_tree("B", den=cpu_den, x=x0.cpu(),
                                                        sig=c3_sig))[1]
    from sonar_tpu_torch.utils.misc import pattern_break

    pb_in = torch.randn(SHAPE, generator=torch.Generator().manual_seed(25))
    rel = rel_err(pattern_break(pb_in.to(dev)), pattern_break(pb_in))[1]
    print(f"[25] pattern_break on one input, card vs CPU: max rel diff {rel:.3e} (tolerance "
          f"{XDEV_TOL:g}); tree B whole at {CONFIG3_STEPS} steps: {whole:.3e} (its hash)")
    need(rel <= XDEV_TOL, f"[25] pattern_break: card and CPU differ ({rel:.3e})")
    torch.backends.cudnn.allow_tf32 = True
    print(f"[25] phases 1-25 took {time.perf_counter() - t_run:.0f} s")

    # -- phase 26: the rest of the noise zoo, the DTCWT and wavelet CFG on it -------------
    t26 = time.perf_counter()
    print(f"[26] {t26 - t_run:.0f} s into the run")
    from scipy import stats as sst

    from sonar_tpu_torch.noise import ScatternetFilteredNoise
    from sonar_tpu_torch.noise import scatternet as SN
    from sonar_tpu_torch.noise.distro import DISTRO_PARAMS, REJECTION, DistroGenerator
    from sonar_tpu_torch.wavelets import dtcwt2d, idtcwt2d

    # (a) four noises under sonar_euler_ancestral, flagship, 20 steps, seed 7
    zoo = {"distro": {"sonar_config": SonarConfig(noise_type="distro")},
           "distro gamma": {"noise_item": get_noise_item("distro", distro="gamma")},
           "collatz": {"sonar_config": SonarConfig(noise_type="collatz")},
           "scatternet": {"noise_item": ScatternetFilteredNoise(noise=get_noise_item("gaussian"))}}

    def run_zoo(k, den=None, x=None, sig=None):
        return sample_sonar_euler_ancestral(den or denoiser, x0 if x is None else x,
                                            sigmas if sig is None else sig, seed=7, **zoo[k])

    l26 = {}
    for k in zoo:
        rec = Recorded(denoiser)
        reset_counts()
        o = run_zoo(k, den=rec)
        l26[k] = read_counts()
        need(o.is_cuda and o.shape == SHAPE and bool(torch.isfinite(o).all()),
             f"[26] {k}: output malformed or not finite")
        need(len(rec.sigmas) == STEPS, f"[26] {k}: {len(rec.sigmas)} model calls")
        want26 = {**ZOO_LAUNCHES[k], "B7": att4 * STEPS}
        need(l26[k] == want26, f"[26] {k}: launches {l26[k]}, expected {want26}")
        # the run under the sync check is the reproducibility run too
        rec = Recorded(denoiser, sync_check=True)
        try:
            again = run_zoo(k, den=rec)
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"[26] {k} synchronised inside a step: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        need(torch.equal(o, again), f"[26] {k} is not reproducible for one seed")
        print(f"[26] {k}: {len(rec.sigmas)} model calls, output std {float(o.std()):.4f}; "
              f"launches {l26[k]}; {STEPS} steps under set_sync_debug_mode('error'): no sync")
    runs26 = {"gaussian": headline, **{k: (lambda _k=k: run_zoo(_k)) for k in zoo}}
    ms26 = {k: [] for k in runs26}
    for _ in range(3):
        for k, fn in runs26.items():
            ms26[k].append(event_ms(torch, fn))
    zoo_stats = {}
    for k, fn in runs26.items():
        v = sorted(ms26[k])
        n26, by26 = profile_run(torch, fn, f"[26] {k}")
        dev26 = sum(by26.values())
        zoo_stats[k] = {"steps_per_s": STEPS / (v[1] / 1000.0), "run_ms": v,
                        "device_kernels": n26, "device_us": dev26,
                        "busy_pct": 100.0 * dev26 / (v[1] * 1000.0)}
        print(f"[26] {k}: {zoo_stats[k]['steps_per_s']:.2f} steps/s (median of "
              f"{[round(t, 2) for t in v]} ms, in turns with the others), {n26} device "
              f"kernels, {dev26:.1f} us device, busy {zoo_stats[k]['busy_pct']:.1f} % [{card}]")
    # card vs CPU at CONFIG3_STEPS steps, one seed, TF32 off. Gamma's accept
    # decisions may differ where B3's normals differ by an ulp (a round's
    # test lands within ~1e-6 of its edge about once in a million): its share
    # of elements past the tolerance must stay under 1e-3, as the draws' must
    torch.backends.cudnn.allow_tf32 = False
    for k in zoo:
        a = run_zoo(k, den=cpu_den, x=x0.cpu(), sig=c3_sig)
        b = run_zoo(k, sig=c3_sig)
        rel = rel_err(b, a)[1]
        past = float(((b.cpu().double() - a.double()).abs()
                      > TRAJ_TOL * float(a.abs().max())).double().mean())
        print(f"[26] {k}, {CONFIG3_STEPS} steps, seed 7, card vs CPU, TF32 off: max rel diff "
              f"{rel:.3e}, share past {TRAJ_TOL:g}: {past:.2e}")
        ok = past <= 1e-3 if k == "distro gamma" else rel <= TRAJ_TOL
        need(b.is_cuda and a.device.type == "cpu" and ok, f"[26] {k}: card and CPU differ")
    torch.backends.cudnn.allow_tf32 = True
    print(f"[26] (a) took {time.perf_counter() - t26:.0f} s")

    # (b) every distribution: one draw card vs CPU (geometric floors a
    # logarithm: an ulp can move an element to the next integer), then 2^20
    # draws on the card by statistics (KS against scipy.stats where a CDF
    # exists, p > 1e-4; else the mean within 5 standard errors, the variance
    # within 10)
    def ks(x, cdf, *args):
        # a scipy.stats name becomes its frozen distribution's CDF (scipy
        # hands some names' args to a ufunc that takes none)
        cdf = getattr(sst, cdf)(*args).cdf if isinstance(cdf, str) else cdf
        r = sst.kstest(x.ravel(), cdf)
        return r.pvalue > 1e-4, f"KS D {r.statistic:.2e} p {r.pvalue:.3f}"

    def moments(x, mean, var):
        x = x.ravel()
        m, v = float(x.mean()), float(x.var())
        ok = (abs(m - mean) <= 5 * math.sqrt(var / x.size)
              and abs(v - var) <= 10 * var * math.sqrt(2.0 / x.size))
        return ok, f"mean {m:.4f} ({mean}), var {v:.4f} ({var})"

    def relaxed(logit, temp):
        return lambda x: 1.0 / (1.0 + np.exp(-(temp * np.log(x / (1.0 - x)) - logit)))

    dist_checks = {
        "exponential": lambda x: ks(x, "expon"), "cauchy": lambda x: ks(x, "cauchy"),
        "geometric": lambda x: moments(x, 4.0, 12.0),
        "log_normal": lambda x: ks(x, "lognorm", 2.0, 0.0, math.e),
        "normal": lambda x: ks(x, "norm"), "beta": lambda x: ks(x, "beta", 0.5, 0.5),
        "continuous_bernoulli": lambda x: ks(x, "uniform"),
        "dirichlet": lambda x: ks(x[..., 0], "beta", 0.5, 0.5),
        "fisher_snedecor": lambda x: ks(x, "f", 1.0, 2.0), "gamma": lambda x: ks(x, "gamma", 1.0),
        "gumbel": lambda x: ks(x, "gumbel_r", 1.0, 2.0),
        "inverse_gamma": lambda x: ks(x, "invgamma", 1.0),
        "kumaraswamy": lambda x: ks(x, "uniform"),
        "laplacian": lambda x: ks(x, "laplace"),
        "lkjcholesky": lambda x: ks(((x[..., 1, :] * x[..., 2, :]).sum(-1) + 1.0) / 2.0, "beta",
                                    1.5, 1.5),
        "lrmvariate_normal": lambda x: ks(x[..., 0], "norm", 0.0, math.sqrt(2.0)),
        "mvariate_normal": lambda x: ks(x, "norm"), "pareto": lambda x: ks(x, "pareto", 1.0),
        "poisson": lambda x: moments(x, 1.5, 1.5),
        "relaxed_bernoulli": lambda x: ks(x, relaxed(math.log(0.66 / 0.34), 0.75)),
        "relaxed_onehotcategorical": lambda x: ks(x[..., 1], relaxed(math.log(2.0), 1.5)),
        "studentt": lambda x: ks(x, "t", 1.0), "uniform": lambda x: ks(x, "uniform"),
        "vonmises": lambda x: ks(x, "vonmises", 1.0, 1.0),
        "weibull": lambda x: ks(x, "weibull_min", 1.0),
        "wishart": lambda x: ks(x[..., 0, 0], "chi2", 2.0),
    }
    need(set(dist_checks) == set(DISTRO_PARAMS), "[26] a distribution has no check")
    big_ctx = NoiseCtx((1, 1, 1024, 1024), device=dev)
    dist_rows = {}
    for d in DISTRO_PARAMS:
        dgen = DistroGenerator(distro=d)
        a = dgen.raw(NoiseCtx(SHAPE, device="cpu"), 26).double()
        b = dgen.raw(NoiseCtx(SHAPE, device=dev), 26)
        need(b.is_cuda and b.shape == a.shape and bool(torch.isfinite(b).all()),
             f"[26] {d}: card draw malformed or not finite")
        diff = (b.cpu().double() - a).abs() / a.abs().clamp(min=1.0)
        past = float((diff > XDEV_TOL).double().mean())
        ok_dev = past <= (1e-3 if d in REJECTION | {"geometric"} else 0.0)
        with np.errstate(divide="ignore"):
            ok_stat, what = dist_checks[d](dgen.raw(big_ctx, 260).double().cpu().numpy())
        dist_rows[d] = {"max_rel": float(diff.max()), "share_past": past, "stat": what}
        print(f"[26] {d:26s} card vs CPU: max rel {float(diff.max()):.2e}, share past "
              f"{XDEV_TOL:g} {past:.2e} ({'rejection' if d in REJECTION else 'transform'}); "
              f"2^20 draws on the card: {what}")
        need(ok_dev, f"[26] {d}: card and CPU draws differ (share {past:.2e})")
        need(ok_stat, f"[26] {d}: statistics of 2^20 card draws off: {what}")
    print(f"[26] (b) took {time.perf_counter() - t26:.0f} s")

    # (c) the DTCWT at 1x4x128x128, level 3, every bank name: reconstruction
    # with the TF32 switches on and off, card vs CPU; scatternet's layers
    xd = torch.randn(SDXL_SHAPE, generator=torch.Generator().manual_seed(26))
    xd_dev = xd.to(dev)
    dtcwt_worst = {"recon": 0.0, "xdev": 0.0}
    bank_cases = ([(b_, "qshift_a") for b_ in ("legall", "near_sym_a", "antonini", "near_sym_b",
                                              "near_sym_a_bp", "near_sym_b_bp", "native")]
                  + [("near_sym_a", q_) for q_ in ("qshift_06", "qshift_b", "qshift_c",
                                                   "qshift_d", "qshift_b_bp", "native")])
    for b_, q_ in bank_cases:
        cl, ch = dtcwt2d(xd, 3, biort=b_, qshift=q_)
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            gl, gh = dtcwt2d(xd_dev, 3, biort=b_, qshift=q_)
            need(gh[0].is_cuda and gh[0].dtype == torch.complex64 and gh[0].shape[2] == 6,
                 f"[26] dtcwt {b_}/{q_}: subbands malformed")
            rec_err = rel_err(idtcwt2d(gl, gh, biort=b_, qshift=q_), xd_dev)[1]
            xdev = max([rel_err(g_, c_)[1] for g_, c_ in zip(gl, cl)]
                       + [rel_err(torch.view_as_real(g_), torch.view_as_real(c_))[1]
                          for g_, c_ in zip(gh, ch)])
            dtcwt_worst["recon"] = max(dtcwt_worst["recon"], rec_err)
            dtcwt_worst["xdev"] = max(dtcwt_worst["xdev"], xdev)
            need(rec_err <= XDEV_TOL and xdev <= XDEV_TOL,
                 f"[26] dtcwt {b_}/{q_}, TF32 {tf32}: reconstruction {rec_err:.2e}, card vs "
                 f"CPU {xdev:.2e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    layer_err = {}
    for lname in ("scat_layer_dwt", "scat_layer_dtcwt", "scat_layer_j2", "scat_layer_j2_dwt"):
        layer = getattr(SN, lname)
        out_c, out_g = layer(xd), layer(xd_dev)
        layer_err[lname] = rel_err(out_g, out_c)[1]
        need(out_g.is_cuda and layer_err[lname] <= XDEV_TOL,
             f"[26] {lname}: card and CPU differ ({layer_err[lname]:.2e})")
    print(f"[26] dtcwt2d/idtcwt2d at {SDXL_SHAPE}, level 3, {len(bank_cases)} bank pairs, TF32 "
          f"on and off: worst reconstruction {dtcwt_worst['recon']:.2e}, worst card vs CPU "
          f"{dtcwt_worst['xdev']:.2e} (tolerance {XDEV_TOL:g}); scatternet layers card vs CPU "
          f"{ {k: float(f'{v:.2e}') for k, v in layer_err.items()} }")
    print(f"[26] (c) took {time.perf_counter() - t26:.0f} s")

    # (d) config 3 with use_dtcwt on the SDXL-class UNet, in turns with [19]'s
    # config 3 on the DWT and with euler + basic CFG
    dt_rules = config3_rules(use_dtcwt=True)
    dt_runs = {**sdxl_pipes(bpair),
               "config3_dtcwt": lambda: config3_pipe(bpair, rules=dt_rules,
                                                     noise=noise_3a())(sx0, sdxl_sig)}
    counted_dt = config3_pipe(counting(bpair), rules=dt_rules, noise=noise_3a())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_guided.clear()
    reset_counts()
    out_dt = counted_dt(sx0, sdxl_sig)
    l26d = read_counts()
    peak_dt = torch.cuda.max_memory_allocated()
    need(out_dt.shape == SDXL_SHAPE and out_dt.is_cuda and bool(torch.isfinite(out_dt).all()),
         "[26] SDXL config 3 on the DTCWT: output malformed or not finite")
    need(len(n_guided) == fwd3 and l26d == want19,
         f"[26] SDXL config 3 on the DTCWT: {len(n_guided)} UNet forwards, launches {l26d}")
    ms26d = {k: [] for k in dt_runs}
    for _ in range(2):  # 3 before [27] needed the room
        for k in ("euler", "config3", "config3_dtcwt"):
            ms26d[k].append(event_ms(torch, dt_runs[k]))
    pc26 = {k: sorted(t / (SDXL_STEPS * (1 if k == "euler" else 2)) for t in v)
            for k, v in ms26d.items()}
    for k, v in pc26.items():
        print(f"[26] SDXL {k}: {med(v):.3f} ms per model call median (min {v[0]:.3f}, max "
              f"{v[-1]:.3f}; 2 runs in turns, run ms {[round(t, 1) for t in ms26d[k]]}) [{card}]")
    ov_dt = 100.0 * (med(pc26["config3_dtcwt"]) / med(pc26["euler"]) - 1.0)
    ov_dwt = 100.0 * (med(pc26["config3"]) / med(pc26["euler"]) - 1.0)
    print(f"[26] config3_dtcwt_overhead_pct {ov_dt:.2f} (config 3 on the DWT in these turns: "
          f"{ov_dwt:.2f}) [{card}]")
    n26d, by26d = profile_run(torch, dt_runs["config3_dtcwt"], "[26] SDXL config 3 DTCWT")
    tot26d = sum(by26d.values())
    wall26d = med(sorted(ms26d["config3_dtcwt"])) * 1000
    print(f"[26] SDXL config 3 on the DTCWT under the profiler: {n26d} device kernels, "
          f"{tot26d:.1f} us device in {wall26d:.1f} us wall (busy {100 * tot26d / wall26d:.1f} "
          f"%); peak device memory {peak_dt / 2**30:.2f} GiB; launches {l26d} [{card}]")
    wdt = wargs(dev, 5.0)
    wdt_fn = lambda: WaveletCFG(rules=dt_rules)(wdt)  # noqa: E731
    wdt_fn()
    wdt_tot, _ = device_us(torch, wdt_fn, 10)
    need(wdt_tot is not None, "[26] DTCWT WCFG call: device time not measured")
    wdt_kernels = device_us.launched
    wdt_host = cuda_ms(torch, wdt_fn, 20)
    print(f"[26] one config-3 WCFG call on the DTCWT at {SDXL_SHAPE}: {wdt_kernels:.0f} device "
          f"kernels, device_us {wdt_tot:.2f}, {wdt_host * 1000:.1f} us by events (the DWT's: "
          f"{wcfg_kernels:.0f} kernels, {w_tot:.2f} us, [17]) [{card}]")
    guided_dt = config3_pipe(pair, rules=dt_rules)._denoiser(sdxl_np)
    guided_dt(gx, g_in, sigma_host=5.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gout_dt = guided_dt(gx, g_in, sigma_host=5.0)
    except RuntimeError as e:
        fail(f"[26] a guided call on the DTCWT synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    need(bool(torch.isfinite(gout_dt).all()), "[26] DTCWT guided call: not finite")
    torch.backends.cudnn.allow_tf32 = False
    on_card = config3_pipe(pair, rules=dt_rules)(
        x0, c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i].to(dev))
    on_cpu = config3_pipe(cpu_pair, rules=dt_rules)(
        x0.cpu(), c3_sig, noise_sampler=lambda i, s, sn: c3_draws[i])
    torch.backends.cudnn.allow_tf32 = True
    err_dt, rel_dt = rel_err(on_card, on_cpu)
    print(f"[26] one guided call on the DTCWT under set_sync_debug_mode('error'): no sync; "
          f"config 3 on the DTCWT, flagship, {CONFIG3_STEPS - 1} steps and the tail on one "
          f"injected stream, card vs CPU, TF32 off: max rel diff {rel_dt:.3e} (tolerance "
          f"{TRAJ_TOL:g})")
    need(on_card.is_cuda and rel_dt <= TRAJ_TOL,
         f"[26] config 3 on the DTCWT: card and CPU differ ({rel_dt:.3e})")
    print(json.dumps({"noise_zoo_rest": zoo_stats, "distributions": dist_rows,
                      "config3_dtcwt_ms_per_model_call": pc26,
                      "config3_dtcwt_overhead_pct": ov_dt}))
    print(f"[26] took {time.perf_counter() - t26:.0f} s; phases 1-26 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 27: the node/workflow API: ComfyUI graphs through pipeline_from_workflow --
    t27 = time.perf_counter()
    print(f"[27] {t27 - t_run:.0f} s into the run")
    import importlib.util

    from sonar_tpu_torch.api import NODES, build, pipeline_from_workflow, port_workflow
    from sonar_tpu_torch.api.schemas import SCHEMAS
    from sonar_tpu_torch.api.validate import ALIASES
    from sonar_tpu_torch.api.workflow import SAMPLER_NODE_CLASSES
    from sonar_tpu_torch.cfg.latent_ops import SonarLatentOperation
    from sonar_tpu_torch.utils import StepTimer, trace

    has_yaml = importlib.util.find_spec("yaml") is not None
    print(f"[27] PyYAML on this machine: {'yes' if has_yaml else 'no'} (the graphs below carry "
          f"widget values only, no yaml_parameters)")

    def widgets(node, **over):
        """Every widget of ``node`` at its schema default, as ComfyUI stores them."""
        return {**{f: s_["d"] for f, s_ in SCHEMAS[node].items()
                   if s_["t"] != "x" and s_.get("d") is not None}, **over}

    def graph_a():
        """BASELINE config 2 (tools/bench_configs.py:33-49) as a ComfyUI graph."""
        return {
            "1": {"class_type": "SonarCustomNoise",
                  "inputs": {"factor": 0.6, "rescale": 0.0, "noise_type": "perlin"}},
            "2": {"class_type": "SonarCustomNoise",
                  "inputs": {"factor": 0.4, "rescale": 0.0, "noise_type": "onef_pinkish",
                             "sonar_custom_noise_opt": ["1", 0]}},
            "3": {"class_type": "SamplerSonarEulerA",
                  "inputs": widgets("SamplerSonarEulerA", momentum=0.95,
                                    custom_noise_opt=["2", 0])},
            "4": {"class_type": "SamplerCustom",
                  "inputs": {"add_noise": True, "noise_seed": 7, "cfg": 7.0,
                             "sampler": ["3", 0]}},
        }

    def graph_b(steps):
        """Pyramid (variant "pyramid": the schema default, highres_pyramid, is
        B5's ladder; its levels set, since at the widget's iterations -1 it
        draws the base alone; 8, the widget's maximum, gives the variant's
        ladder at 64x64, which ends at 1x1 after four levels) chained with
        Voronoi into SamplerSonarEulerA; wavelet CFG at its widget defaults,
        no YAML; Karras sigmas; host SamplerCustom."""
        return {
            "1": {"class_type": "CheckpointLoaderSimple", "inputs": {"ckpt_name": "model"}},
            "2": {"class_type": "SonarAdvancedPyramidNoise",
                  "inputs": widgets("SonarAdvancedPyramidNoise", factor=0.5, variant="pyramid",
                                    iterations=8, discount=0.7, upscale_mode="bilinear")},
            "3": {"class_type": "SonarAdvancedVoronoiNoise",
                  "inputs": widgets("SonarAdvancedVoronoiNoise", factor=0.5,
                                    sonar_custom_noise_opt=["2", 0])},
            "4": {"class_type": "SamplerSonarEulerA",
                  "inputs": widgets("SamplerSonarEulerA", custom_noise_opt=["3", 0])},
            "5": {"class_type": "SonarWaveletCFG",
                  "inputs": {k: v for k, v in widgets("SonarWaveletCFG", model=["1", 0]).items()
                             if k != "yaml_parameters"}},
            "6": {"class_type": "KarrasScheduler",
                  "inputs": {"steps": steps, "sigma_max": 14.6, "sigma_min": 0.03, "rho": 7.0}},
            "7": {"class_type": "SamplerCustom",
                  "inputs": {"model": ["5", 0], "add_noise": True, "noise_seed": 7, "cfg": 7.0,
                             "sampler": ["4", 0], "sigmas": ["6", 0]}},
        }

    def sync_checked(what, run):
        try:
            out_ = run()
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"[27] {what} synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return out_

    port_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        res_a = port_workflow(graph_a(), model_sampling=ms3)
        port_ms.append((time.perf_counter() - t0) * 1000)
    port_ms.sort()
    need(not res_a.failed and res_a.host_sampler == {"add_noise": True, "noise_seed": 7,
                                                     "cfg": 7.0},
         f"[27] graph (a) ported with {res_a.summary()}")
    print(f"[27] port_workflow of graph (a), 4 nodes: {port_ms[2]:.3f} ms host time (median of "
          f"5; min {port_ms[0]:.3f}, max {port_ms[-1]:.3f}); {res_a.summary()!r}")

    # (a) config 2 as a workflow on [19]'s SDXL-class module, 1x4x128x128, 30 steps
    def pipe_a(p):
        return pipeline_from_workflow(graph_a(), model=p[0], model_uncond=p[1],
                                      model_sampling=ms3)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_guided.clear()
    reset_counts()
    out_a = pipe_a(counting(bpair))(sx0, sdxl_sig)
    l27a = read_counts()
    peak_a = torch.cuda.max_memory_allocated()
    need(out_a.shape == SDXL_SHAPE and out_a.is_cuda and bool(torch.isfinite(out_a).all()),
         "[27] (a): output malformed or not finite")
    need(len(n_guided) == 2 * SDXL_STEPS, f"[27] (a): {len(n_guided)} UNet forwards")
    need(l27a == l21["config2"], f"[27] (a): launches {l27a}, [21]'s config 2 {l21['config2']}")
    need(torch.equal(out_a, keep21["out"]), "[27] (a): differs from [21]'s config 2")
    need(abs(peak_a - peak21["config2"]) <= 0.1 * 2**30,
         f"[27] (a): peak {peak_a / 2**30:.2f} GiB, [21]'s {peak21['config2'] / 2**30:.2f}")
    print(f"[27] (a) config 2 as a workflow, {SDXL_SHAPE}, {SDXL_STEPS} steps: "
          f"{len(n_guided) // 2} guided calls; launches {l27a} (= [21]'s config 2); output "
          f"bit-equal to [21]'s config 2; peak device memory {peak_a / 2**30:.2f} GiB "
          f"([21]: {peak21['config2'] / 2**30:.2f}) [{card}]")
    wf_a = pipe_a(bpair)
    runs27 = {"config2": keep21["run"], "workflow_a": lambda: wf_a(sx0, sdxl_sig)}
    ms27 = {k: [] for k in runs27}
    for which in ("config2", "workflow_a", "workflow_a", "config2"):
        ms27[which].append(event_ms(torch, runs27[which]))
    per27 = {k: sorted(t / SDXL_STEPS for t in v) for k, v in ms27.items()}
    for k, v in per27.items():
        print(f"[27] {k}: {med(v):.3f} ms per model call median (min {v[0]:.3f}, max "
              f"{v[-1]:.3f}; 2 runs interleaved, run ms {[round(t, 1) for t in ms27[k]]}) [{card}]")
    guided_a = wf_a._denoiser(sdxl_np)
    sa_in = torch.full((1,), 5.0, device=dev)
    guided_a(sx0, sa_in, sigma_host=5.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    sync_checked("a guided call of (a)", lambda: guided_a(sx0, sa_in, sigma_host=5.0))
    print("[27] one guided call of (a) under set_sync_debug_mode('error'): no sync")

    # (b) a kernel-heavy workflow on the flagship, 1x4x64x64, 20 steps
    def pipe_b(p, steps=STEPS):
        return pipeline_from_workflow(graph_b(steps), model=p[0], model_uncond=p[1],
                                      model_sampling=ms3)

    wf_b, res_b = pipe_b(pair)
    sig_b = res_b.sigmas
    need(not res_b.failed and wf_b.wavelet_cfg is not None and sig_b.shape == (STEPS + 1,),
         f"[27] graph (b) ported with {res_b.summary()}")
    reset_counts()
    out_b = wf_b(x0, sig_b)
    l27b = read_counts()
    need(out_b.is_cuda and out_b.shape == SHAPE and bool(torch.isfinite(out_b).all()),
         "[27] (b): output malformed or not finite")
    # a step: the momentum step (B1), a scale_noise for each of the two
    # items (B2), the pyramid's three smaller levels and Voronoi's fresh
    # feature points for its three octaves (B3: z_max_mode "reset" draws
    # them every step and keeps them where z passed z_max), the pyramid's
    # upscale (B4), one B6 for each octave; the points at set-up (B3, three)
    want27b = {"B1": STEPS, "B2": 2 * STEPS, "B3": 6 * STEPS + 3, "B4": STEPS, "B5": 0,
               "B6": 3 * STEPS}
    # B7: each UNet forward of the guided steps, at every attention block
    need(b1_b6(l27b) == want27b and l27b["B7"] > 0 and l27b["B7"] % att4 == 0,
         f"[27] (b): launches {l27b}, expected {want27b} and B7 {att4} a UNet forward")
    need(torch.equal(out_b, wf_b(x0, sig_b)), "[27] (b): not reproducible")
    # [23]'s Recorded as the cond model turns the check on at its first call
    sync_b = pipeline_from_workflow(graph_b(STEPS), model=Recorded(pair[0], sync_check=True),
                                    model_uncond=pair[1], model_sampling=ms3)[0]
    sync_checked("(b)'s run", lambda: sync_b(x0, sig_b))
    print(f"[27] (b) pyramid + Voronoi + wavelet CFG as a workflow, {cfg} {SHAPE}, {STEPS} "
          f"steps: launches {l27b}; reproducible; the run after its first model call under "
          f"set_sync_debug_mode('error'): no sync [{card}]")
    runs27b = {"gaussian": headline, "workflow_b": lambda: wf_b(x0, sig_b)}
    ms27b = {k: [] for k in runs27b}
    for _ in range(3):
        for k, fn in runs27b.items():
            ms27b[k].append(event_ms(torch, fn))
    b_stats = {}
    for k, fn in runs27b.items():
        v = sorted(ms27b[k])
        n27, by27 = profile_run(torch, fn, f"[27] {k}")
        dev27 = sum(by27.values())
        b_stats[k] = {"steps_per_s": STEPS / (v[1] / 1000.0), "run_ms": v,
                      "device_kernels": n27, "device_us": dev27,
                      "busy_pct": 100.0 * dev27 / (v[1] * 1000.0)}
        print(f"[27] {k}: {b_stats[k]['steps_per_s']:.2f} steps/s (median of "
              f"{[round(t, 2) for t in v]} ms, in turns), {n27} device kernels, "
              f"{dev27:.1f} us device, busy {b_stats[k]['busy_pct']:.1f} % [{card}]")
    torch.backends.cudnn.allow_tf32 = False
    wb_card, rb_card = pipe_b(pair, CONFIG3_STEPS)
    wb_cpu, _ = pipe_b(cpu_pair, CONFIG3_STEPS)
    rel_b = rel_err(wb_card(x0, rb_card.sigmas), wb_cpu(x0.cpu(), rb_card.sigmas))[1]
    torch.backends.cudnn.allow_tf32 = True
    print(f"[27] (b) at {CONFIG3_STEPS} steps, noise live (one Philox stream), card vs CPU, "
          f"TF32 off: max rel diff {rel_b:.3e} (tolerance {TRAJ_TOL:g})")
    need(rel_b <= TRAJ_TOL, f"[27] (b): card and CPU differ ({rel_b:.3e})")
    timer = StepTimer()
    timer.start()
    wf_b(x0, sig_b, callback=timer)
    st27 = timer.summary()
    need(st27["steps"] == STEPS, f"[27] StepTimer: {st27}")
    print(f"[27] (b) under StepTimer (an event a step, one synchronisation): "
          f"p50 {st27['p50_ms']:.3f} ms, p90 {st27['p90_ms']:.3f} ms, "
          f"mean {st27['mean_ms']:.3f} ms [{card}]")
    with trace(os.path.join(ROOT, "build", "trace27")) as trace_path:
        wf_b(x0, sig_b[-3:])  # one step and the tail
    need(os.path.getsize(trace_path) > 0, "[27] trace: no trace file")
    print(f"[27] trace of one step and the tail: {os.path.relpath(trace_path, ROOT)}, "
          f"{os.path.getsize(trace_path)} bytes")

    # (c) every node name, built on the card from its schema defaults
    gen27 = torch.Generator().manual_seed(27)
    card_latent = torch.randn(SHAPE, generator=gen27).to(dev)
    links = {"OCS_NOISE,SONAR_CUSTOM_NOISE": lambda: NoiseChain([get_noise_item("gaussian")]),
             "SONAR_POWER_FILTER": PowerFilter, "LATENT": lambda: card_latent,
             "MASK": lambda: torch.ones(SHAPE[-2:], device=dev),
             "IMAGE": lambda: torch.full((1, 64, 64, 3), 0.5, device=dev),
             "SIGMAS": lambda: sig_b[:3].clone(),
             "LATENT_OPERATION": SonarLatentOperation, "SAMPLER": lambda: "sonar_euler"}
    adapted = {"SonarScheduledNoise": {"model_sampling": ms3},
               "FreeUExtreme": {"model_sampling": ms3, "model_channels": cfg.model_channels},
               "NoisyLatentLike": {"model_sampling": ms3},
               "KSamplerSelect": {"sampler_name": "euler"},
               "SonarToComfyNOISE": {"sonar_custom_noise": links[
                   "OCS_NOISE,SONAR_CUSTOM_NOISE"](), "seed": 3},
               "BasicScheduler": {"model_sampling": ms3}}
    sig2 = bench_sigmas(torch, 2)
    kinds = {"noise": [], "sampler": [], "tensor": [], "other": []}
    reset_counts()
    for node in sorted(NODES):
        schema = SCHEMAS.get(ALIASES.get(node, node), {}) if node != "SonarToComfyNOISE" else {}
        # no upstream chain: each noise node's draw is its own item alone
        params = {f: (links[s_["ty"]]() if s_["t"] == "x" else s_["d"])
                  for f, s_ in schema.items() if f not in ("model", "sonar_custom_noise_opt")
                  and (s_["ty"] in links if s_["t"] == "x" else s_.get("d") is not None)}
        params.update(adapted.get(node, {}))
        try:
            obj = build(node, **params)
        except Exception as e:  # noqa: BLE001 — name the node, then stop
            fail(f"[27] node {node} did not build on the card: {type(e).__name__}: {e}")
        if isinstance(obj, NoiseItem):
            fn, st_ = make_noise_sampler(obj, SHAPE, device=dev, seed=11, sigma_min=0.03,
                                         sigma_max=14.6)
            n_ = fn(st_, 1.0, 0.5)[0]
            s_ = float(n_.std())
            need(n_.is_cuda and n_.shape == SHAPE and bool(torch.isfinite(n_).all())
                 and abs(s_ - 1.0) < 0.05, f"[27] node {node}: draw {n_.shape} std {s_}")
            kinds["noise"].append(node)
        elif node in SAMPLER_NODE_CLASSES:
            o = obj(denoiser, x0, sig2, seed=7)
            need(o.is_cuda and o.shape == SHAPE and bool(torch.isfinite(o).all()),
                 f"[27] node {node}: 2 steps malformed or not finite")
            kinds["sampler"].append(node)
        elif hasattr(obj, "generate_noise"):  # the ComfyUI NOISE adapter, both names
            o = obj.generate_noise({"samples": card_latent, "batch_index": [1, 0]})
            need(o.is_cuda and bool(torch.isfinite(o).all()), f"[27] {node}: malformed")
            kinds["noise"].append(node)
        elif isinstance(obj, (torch.Tensor, np.ndarray)):
            o = torch.as_tensor(obj)
            need(bool(torch.isfinite(o.float()).all()) and (o.is_cuda or isinstance(
                obj, np.ndarray) or node.endswith("Scheduler")), f"[27] node {node}: {o.device}")
            kinds["tensor"].append(node)
        else:
            kinds["other"].append(node)
    l27c = read_counts()
    need(sum(len(v) for v in kinds.values()) == len(NODES) == 60 and l27c["B5"] > 0,
         f"[27] node sweep: {kinds}, launches {l27c}")
    print(f"[27] (c) all {len(NODES)} node names built on the card from their schema defaults: "
          f"{len(kinds['noise'])} noises drawn once at {SHAPE} (finite, std within 0.05 of 1), "
          f"{len(kinds['sampler'])} samplers run 2 steps on the flagship, "
          f"{len(kinds['tensor'])} tensors or images, {len(kinds['other'])} other objects "
          f"({', '.join(kinds['other'])}); launches {l27c}")
    print(json.dumps({"workflow": {
        "port_workflow_ms_graph_a": port_ms[2], "a_launches": l27a,
        "a_ms_per_model_call": {k: med(v) for k, v in per27.items()},
        "a_peak_gib": peak_a / 2**30, "config2_peak_gib": peak21["config2"] / 2**30,
        "b_launches": l27b, "b": b_stats, "b_card_vs_cpu_rel": rel_b,
        "b_step_timer": st27, "c_launches": l27c, "yaml": has_yaml}}))
    del big, bpair, dt_runs, counted_dt, out_dt, keep21, wf_a, runs27
    print(f"[27] took {time.perf_counter() - t27:.0f} s; phases 1-27 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 28: the model tier: DiT-S/2 serving and training, checkpoints --------------
    print(f"[28] {time.perf_counter() - t_run:.0f} s into the run")
    t28 = time.perf_counter()
    import dataclasses
    import functools
    import shutil
    import warnings

    import torch.nn.functional as TF

    import sonar_tpu_torch.models.train as TR
    from sonar_tpu_torch.cfg import Flow
    from sonar_tpu_torch.models import (H100_PEAK_FLOPS, DiTConfig, dit_forward_flops,
                                        init_dit_params, init_train_state, make_dit_denoiser,
                                        make_train_step, mfu_pct, restore_checkpoint,
                                        save_checkpoint)

    def no_sync(what, run):
        """``run`` under ``set_sync_debug_mode("error")`` from its start (or
        from where ``run`` turns it on), off again after it."""
        try:
            out_ = run()
            torch.cuda.synchronize()
        except RuntimeError as e:
            fail(f"[28] {what} synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return out_

    def dit_model(dtype=torch.float32, seed=0, **kw):
        return init_dit_params(torch.Generator().manual_seed(seed),
                               dataclasses.replace(dit_cfg, dtype=dtype, **kw), device=dev)

    # (a) DiT-S/2 serving the headline's sampler
    dit_cfg = DiTConfig(hidden=384, depth=12, num_heads=6, patch_size=2)  # bench.py:174
    dit = dit_model()
    att28 = attention_blocks(dit)  # its 12 blocks
    n_par = sum(p.numel() for p in dit.parameters())
    dit_den = make_dit_denoiser(dit)

    def dit_run(den=dit_den, sig=sigmas, **kw):
        return sample_sonar_euler_ancestral(den, x0, sig, seed=7, **kw)

    reset_counts()
    out_d = dit_run()
    l28a = read_counts()
    need(out_d.is_cuda and out_d.shape == SHAPE and out_d.dtype == torch.float32
         and bool(torch.isfinite(out_d).all()), "[28] (a): output malformed or not finite")
    want28a = {"B1": STEPS, "B2": STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0,
               "B7": att28 * STEPS}
    need(l28a == want28a, f"[28] (a): launches {l28a}, expected {want28a}")
    need(torch.equal(out_d, dit_run()), "[28] (a): not reproducible for one seed")
    no_sync("(a)'s run after its first model call",
            lambda: dit_run(Recorded(dit_den, sync_check=True)))
    print(f"[28] (a) {dit_cfg}, {n_par / 1e6:.2f} M parameters, {SHAPE}, {STEPS} Karras steps, "
          f"seed 7: output std {float(out_d.std()):.4f}; launches {l28a}; reproducible; the run "
          f"after its first model call under set_sync_debug_mode('error'): no sync [{card}]")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    raw28 = [randn(SHAPE) * 1.3 + 0.2 for _ in range(STEPS)]
    kern = dit_run(use_fused=None, noise_sampler=lambda i, s, sn: F.fused_scale_noise(raw28[i]))
    plain = dit_run(use_fused=False,
                    noise_sampler=lambda i, s, sn: F.fused_scale_noise_reference(raw28[i]))
    rel_kp = rel_err(kern, plain)[1]
    need(rel_kp <= TRAJ_TOL, f"[28] (a): kernel and plain trajectories differ: {rel_kp:.3e}")
    sig4 = bench_sigmas(torch, CONFIG3_STEPS)
    g28 = torch.Generator().manual_seed(28)
    inj = [torch.randn(SHAPE, generator=g28) for _ in range(CONFIG3_STEPS)]
    cpu_dit = copy.deepcopy(dit).cpu()
    on_card = dit_run(sig=sig4, noise_sampler=lambda i, s, sn: inj[i].to(dev))
    on_cpu = sample_sonar_euler_ancestral(make_dit_denoiser(cpu_dit), x0.cpu(), sig4,
                                          noise_sampler=lambda i, s, sn: inj[i])
    rel_cc = rel_err(on_card, on_cpu)[1]
    need(rel_cc <= TRAJ_TOL, f"[28] (a): card and CPU differ ({rel_cc:.3e})")

    def own_rel(a, b):
        """max |a - b| relative to max |b|, ``b`` on the CPU."""
        return float((a.cpu().double() - b.double()).abs().max()) / float(b.double().abs().max())

    # the init's 1e-2 head keeps the DiT's share of a sampler step small, so
    # the raw forward is held too: each block on the card's input, and the
    # whole eps, each relative to its own largest value
    xd = torch.randn(SHAPE, generator=torch.Generator().manual_seed(280))
    sd = torch.full((1,), 2.0)
    seen_d = []
    hooks = [blk.register_forward_hook(lambda mod, args, out: seen_d.append(
        (args[0], args[1], out[0]))) for blk in dit.blocks]
    with torch.no_grad():
        eps_g = dit(xd.to(dev), sd.to(dev))
        eps_c = cpu_dit(xd, sd)
        for h_ in hooks:
            h_.remove()
        need(len(seen_d) == dit_cfg.depth, "[28] (a): block hooks")
        blk_rel_d = max(own_rel(h_out, cpu_dit.blocks[i](h_in.cpu(), emb.cpu())[0])
                        for i, (h_in, emb, h_out) in enumerate(seen_d))
    eps_rel = own_rel(eps_g, eps_c)
    need(blk_rel_d <= TRAJ_TOL and eps_rel <= TRAJ_TOL,
         f"[28] (a): the raw forward, card vs CPU: blocks {blk_rel_d:.3e}, eps {eps_rel:.3e}")
    del cpu_dit, kern, plain, raw28, seen_d
    torch.backends.cudnn.allow_tf32 = True
    print(f"[28] (a) TF32 off: kernel path vs plain path on one injected stream, {STEPS} steps: "
          f"max rel diff {rel_kp:.3e}; card vs CPU at {CONFIG3_STEPS} steps on one injected "
          f"stream: {rel_cc:.3e} (tolerance {TRAJ_TOL:g}); one forward at sigma 2, card vs "
          f"CPU: each block on the card's input within {blk_rel_d:.3e} of its largest output, "
          f"eps within {eps_rel:.3e} of its largest |eps| {float(eps_c.abs().max()):.4e}")
    runs28 = {"gaussian": headline, "dit": dit_run}
    ms28 = {k: [] for k in runs28}
    for _ in range(3):
        for k, fn in runs28.items():
            ms28[k].append(event_ms(torch, fn))
    a_stats = {}
    for k, fn in runs28.items():
        v = sorted(ms28[k])
        n_k, by_k = profile_run(torch, fn, f"[28] {k}")
        dev_k = sum(by_k.values())
        a_stats[k] = {"steps_per_s": STEPS / (v[1] / 1000.0), "run_ms": v, "device_kernels": n_k,
                      "device_us": dev_k, "busy_pct": 100.0 * dev_k / (v[1] * 1000.0)}
        print(f"[28] {k}: {a_stats[k]['steps_per_s']:.2f} steps/s (median of "
              f"{[round(t, 2) for t in v]} ms, in turns), {n_k} device kernels, {dev_k:.1f} us "
              f"device, busy {a_stats[k]['busy_pct']:.1f} % [{card}]")
        if k == "dit":
            top = sorted(by_k.items(), key=lambda kv: -kv[1])[:6]
            print("[28] dit: device time by kernel, largest: " + "; ".join(
                f"{nm[:60]} {us / dev_k * 100:.1f} %" for nm, us in top))
    torch.cuda.synchronize()
    resident_a = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dit_run()
    torch.cuda.synchronize()
    peak_a = torch.cuda.max_memory_allocated() - resident_a
    flops_fwd = dit_forward_flops(dit_cfg, SHAPE)
    call_ms = a_stats["dit"]["run_ms"][1] / STEPS
    mfu_wall = mfu_pct(flops_fwd, call_ms)
    mfu_dev = mfu_pct(flops_fwd, a_stats["dit"]["device_us"] / 1000.0 / STEPS)
    print(f"[28] (a) dit_forward_flops {flops_fwd / 1e9:.2f} GFLOP a model call; "
          f"dit_sampler_mfu_pct {mfu_wall:.3f} % ({call_ms:.3f} ms a step by events; the "
          f"H100's dense bf16 peak {H100_PEAK_FLOPS / 1e12:.1f} TFLOP/s, float32 program), "
          f"{mfu_dev:.3f} % on device time a step; peak memory {peak_a / 2**30:.3f} GiB above "
          f"the resident {resident_a / 2**30:.2f} [{card}]")
    dit_bf = dit_model(torch.bfloat16)
    out_bf = dit_run(make_dit_denoiser(dit_bf))
    need(out_bf.dtype == torch.float32 and out_bf.shape == SHAPE
         and bool(torch.isfinite(out_bf).all()), "[28] (a): bf16 DiT output malformed")
    bf_err, bf_rel = rel_err(out_bf, out_d)
    print(f"[28] (a) dtype=torch.bfloat16 DiT, same seed: float32 output, finite; max abs diff "
          f"from the float32 run {bf_err:.4e} (rel {bf_rel:.3e}, output max "
          f"{float(out_d.abs().max()):.3f})")
    del dit_bf, out_bf

    # (b) Switch-MoE at DiT-S width: one forward, card against CPU block by block
    moe = dit_model(num_experts=4)
    moe_cpu = copy.deepcopy(moe).cpu()
    e_n = moe.cfg.num_experts
    xm = torch.randn(SHAPE, generator=torch.Generator().manual_seed(281))
    sm = torch.full((1,), 2.0)
    seen = {"blocks": [], "router": []}
    hooks = [blk.register_forward_hook(lambda mod, args, out: seen["blocks"].append(
        (args[0], args[1], out[0]))) for blk in moe.blocks]
    hooks += [blk.router.register_forward_hook(lambda mod, args, out: seen["router"].append(out))
              for blk in moe.blocks]
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        out_m, aux_m = moe(xm.to(dev), sm.to(dev), return_aux=True)
        out_mc, aux_mc = moe_cpu(xm, sm, return_aux=True)
    for h_ in hooks:
        h_.remove()
    need(len(seen["blocks"]) == len(seen["router"]) == dit_cfg.depth, "[28] (b): hooks")

    def route(logits, c):
        """Each token's expert and whether it is kept (its rank among the
        sample's tokens routed there below the capacity)."""
        idx = torch.softmax(logits.float(), -1).argmax(-1)
        onehot = TF.one_hot(idx, e_n).float()
        pos = (torch.cumsum(onehot, 1) * onehot).sum(-1) - 1.0
        return idx, pos < c

    cap = moe.cfg.expert_capacity(seen["blocks"][0][0].shape[1])
    moved = total = 0
    blk_rel = 0.0
    drops = 0
    for i, ((h_in, emb, h_out), logits) in enumerate(zip(seen["blocks"], seen["router"])):
        cpu_logits = []
        hk = moe_cpu.blocks[i].router.register_forward_hook(
            lambda mod, args, out: cpu_logits.append(out))
        with torch.no_grad():
            h_cpu = moe_cpu.blocks[i](h_in.cpu(), emb.cpu())[0]
        hk.remove()
        idx_g, keep_g = (t.cpu() for t in route(logits, cap))
        idx_c, keep_c = route(cpu_logits[0], cap)
        same = (idx_g == idx_c) & (keep_g == keep_c)
        moved += int((idx_g != idx_c).sum())
        total += idx_g.numel()
        drops += int((~keep_c).sum())
        rows = (h_out.cpu()[same] - h_cpu[same]).abs().max()
        blk_rel = max(blk_rel, float(rows) / max(1.0, float(h_cpu.abs().max())))
    moe_share = moved / total
    whole_rel = rel_err(out_m, out_mc)[1]
    torch.backends.cudnn.allow_tf32 = True
    need(blk_rel <= TRAJ_TOL, f"[28] (b): tokens routed alike differ by {blk_rel:.3e}")
    need(moe_share <= 1e-3, f"[28] (b): {moved} of {total} tokens routed differently")
    # aux counts the routed tokens: one token routed elsewhere moves it by ~E/N
    need(min(float(aux_m), float(aux_mc)) >= 1.0 - 1e-6
         and abs(float(aux_m) - float(aux_mc)) <= 1e-5 + moved * e_n / total,
         f"[28] (b): aux {float(aux_m)} (CPU {float(aux_mc)})")
    moe_den = make_dit_denoiser(moe)
    no_sync("(b)'s run after its first model call",
            lambda: dit_run(Recorded(moe_den, sync_check=True)))
    moe_ms = event_ms(torch, lambda: dit_run(moe_den))
    print(f"[28] (b) {moe.cfg}: one forward at sigma 2, card vs CPU, TF32 off, each block on "
          f"the card's input: {moved} of {total} routing decisions differ "
          f"({moe_share:.2e}); the rest within {blk_rel:.3e} (tolerance {TRAJ_TOL:g}); "
          f"{drops} past the capacity {cap}; whole forward {whole_rel:.3e}; aux {float(aux_m):.6f} "
          f"(CPU {float(aux_mc):.6f}); {STEPS} steps of serving: {STEPS / (moe_ms / 1000):.2f} "
          f"steps/s ({moe_ms:.2f} ms, one run), a run after its first model call under the "
          f"sync check: no sync [{card}]")
    del moe, moe_cpu, moe_den, seen, out_m, out_mc

    # (c) training DiT-S/2 at batch 16, (d) checkpoints
    t_batch = torch.randn((16,) + SHAPE[1:], generator=torch.Generator().manual_seed(282)).to(dev)
    adam = functools.partial(torch.optim.Adam, lr=2e-3)
    ckpt = os.path.join(ROOT, "build", "ckpt28")
    settings = {"float32": {}, "remat full": {"remat": "full"}, "remat dots": {"remat": "dots"},
                "bf16": {"compute_dtype": torch.bfloat16}}
    # B3 at the training draws' own shapes, (16,) and (16, 4, 64, 64), against
    # its plain version (before the counts are reset: these launches compare)
    u_k, e_k = TR.train_draws(TRAIN_SEED, t_batch)
    u_p = H.philox_rand_reference(derive_seed(TRAIN_SEED, "train", "sigma"), (16,), device=dev)
    e_p = H.philox_randn_reference(derive_seed(TRAIN_SEED, "train", "eps"), t_batch.shape,
                                   device=dev)
    train_b3_err = float((e_k - e_p).abs().max())
    need(u_k.shape == u_p.shape and torch.equal(u_k, u_p) and e_k.shape == e_p.shape
         and train_b3_err <= B3_TOL,
         f"[28] (c): train_draws against B3's plain version: normals {train_b3_err:.3e}")
    b3_err = max(b3_err, train_b3_err)
    print(f"[28] (c) train_draws on the card: uniforms {tuple(u_k.shape)} bitwise equal to B3's "
          f"plain version, normals {tuple(e_k.shape)} within {train_b3_err:.3e} (tolerance "
          f"{B3_TOL:g} absolute)")
    del u_k, e_k, u_p, e_p
    train, grads0 = {}, {}
    for nm, kw in settings.items():
        m = dit_model()
        opt = init_train_state(m, adam)
        step = make_train_step(dit_cfg, **kw)
        reset_counts()
        losses = [step(m, opt, t_batch, TRAIN_SEED)]
        if nm != "bf16":
            grads0[nm] = [p.grad.detach().cpu() for p in m.parameters()]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
        losses.append(no_sync(f"(c) {nm}: the second step",
                              lambda: step(m, opt, t_batch, TRAIN_SEED)))
        evs = []
        for i in range(3, TRAIN_STEPS + 1):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            losses.append(step(m, opt, t_batch, TRAIN_SEED))
            ev[1].record()
            evs.append(ev)
            if nm == "float32" and i == CKPT_STEP:
                state = {"params": m.state_dict(), "opt_state": opt.state_dict(), "step": i}
                save_checkpoint(ckpt, state, force=True)
                # host copies (Adam's step counts are host tensors the next step bumps)
                saved = {"params": {k: v.to("cpu", copy=True) for k, v in state["params"].items()},
                         "state": {j: {k: v.to("cpu", copy=True) for k, v in s_.items()}
                                   for j, s_ in state["opt_state"]["state"].items()},
                         "param_groups": copy.deepcopy(state["opt_state"]["param_groups"])}
                del state
            if nm == "float32" and i == CKPT_STEP + 1:
                after = {k: v.to("cpu", copy=True) for k, v in m.state_dict().items()}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        step_ms = sorted(a.elapsed_time(b) for a, b in evs)
        ls = torch.stack(losses).tolist()
        need(all(math.isfinite(v) for v in ls) and ls[-1] < 0.9 * ls[0],
             f"[28] (c) {nm}: losses {ls}")
        need(all(p.dtype == torch.float32 for p in m.parameters()),
             f"[28] (c) {nm}: master weights are not float32")
        # B7: each forward's blocks, and again where remat recomputes the forward
        need(counts == {"B1": 0, "B2": 0, "B3": 2 * TRAIN_STEPS, "B4": 0, "B5": 0, "B6": 0,
                        "B7": att28 * TRAIN_STEPS * (2 if "remat" in kw else 1)},
             f"[28] (c) {nm}: launches {counts}")
        train[nm] = {"losses": ls, "steps_per_s": 1000.0 / step_ms[len(step_ms) // 2],
                     "step_ms": step_ms, "peak_gib": peak / 2**30,
                     "activation_peak_gib": (peak - resident) / 2**30, "launches": counts}
        print(f"[28] (c) {nm}: loss {ls[0]:.5f} -> {ls[-1]:.5f} in {TRAIN_STEPS} steps; "
              f"{train[nm]['steps_per_s']:.2f} steps/s (median of {len(step_ms)} steps by "
              f"events, {step_ms[0]:.2f}-{step_ms[-1]:.2f} ms); peak memory "
              f"{peak / 2**30:.2f} GiB, {(peak - resident) / 2**30:.2f} above the resident "
              f"{resident / 2**30:.2f}; launches {counts}; the second step under the sync "
              f"check: no sync [{card}]")
        if nm == "float32":
            l28c = counts
        del m, opt
    gmax = max(float(g.abs().max()) for g in grads0["float32"])
    remat_rel = {nm: max(float((a - b).abs().max()) for a, b in zip(grads0[nm], grads0["float32"]))
                 / gmax for nm in ("remat full", "remat dots")}
    need(all(v <= 1e-6 for v in remat_rel.values()),
         f"[28] (c) remat changes the first step's gradients: {remat_rel}")
    bf_first = abs(train["bf16"]["losses"][0] - train["float32"]["losses"][0])
    need(bf_first <= 0.05 * train["float32"]["losses"][0],
         f"[28] (c) bf16 first loss {train['bf16']['losses'][0]} against "
         f"{train['float32']['losses'][0]}")
    print(f"[28] (c) first step's gradients against remat=False, relative to the largest "
          f"({gmax:.4e}): {remat_rel}; bf16's first loss {bf_first / train['float32']['losses'][0]:.3e} "
          f"from float32's")
    del grads0

    fresh = dit_model(seed=1)
    fresh_opt = init_train_state(fresh, adam)
    restored = restore_checkpoint(ckpt)
    need(restored["step"] == CKPT_STEP and set(restored) == {"params", "opt_state", "step"},
         f"[28] (d): restored {set(restored)}")
    bit_equal = all(torch.equal(restored["params"][k].cpu(), v)
                    for k, v in saved["params"].items())
    bit_equal &= all(torch.equal(restored["opt_state"]["state"][j][k].cpu(), v)
                     for j, s_ in saved["state"].items() for k, v in s_.items())
    need(bit_equal and restored["opt_state"]["param_groups"] == saved["param_groups"],
         "[28] (d): the restored state differs from the saved one")
    fresh.load_state_dict(restored["params"])
    fresh_opt.load_state_dict(restored["opt_state"])
    loss_r = float(make_train_step(dit_cfg)(fresh, fresh_opt, t_batch, TRAIN_SEED))
    loss_u = train["float32"]["losses"][CKPT_STEP]
    resume_rel = max(float((fresh.state_dict()[k].cpu() - v).abs().max())
                     / max(1.0, float(v.abs().max())) for k, v in after.items())
    need(abs(loss_r - loss_u) <= 1e-6 * abs(loss_u) and resume_rel <= 1e-6,
         f"[28] (d): step {CKPT_STEP + 1} after the restore: loss {loss_r} against {loss_u}, "
         f"weights {resume_rel:.3e}")
    # the restore leaves Adam's step counts on the host (F13): a later step
    # reads nothing back
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            make_train_step(dit_cfg)(fresh, fresh_opt, t_batch, TRAIN_SEED)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    resumed_syncs = sum("synchroniz" in str(w.message) for w in caught)
    need(resumed_syncs == 0 and all(s_["step"].device.type == "cpu"
                                    for s_ in fresh_opt.state.values()),
         f"[28] (d): a step after the restore synchronised {resumed_syncs} times")
    part = restore_checkpoint(ckpt, target={"params": fresh.state_dict()}, partial=True)
    need(set(part) == {"params"} and all(
        t.is_cuda and torch.equal(t.cpu(), saved["params"][k]) for k, t in part["params"].items()),
        "[28] (d): the partial restore of the params")
    ckpt_mb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 2**20
    shutil.rmtree(ckpt)
    print(f"[28] (d) checkpoint after step {CKPT_STEP} of the float32 run ({ckpt_mb:.1f} MiB): "
          f"restored bit-equal; step {CKPT_STEP + 1} on a fresh module and optimizer: loss "
          f"{loss_r:.7f} against {loss_u:.7f} uninterrupted, weights within {resume_rel:.3e}; "
          f"a partial restore of the params alone; a later step under "
          f"set_sync_debug_mode('warn'): {resumed_syncs} synchronising calls (Adam's step counts "
          f"restored on the host)")
    del fresh, fresh_opt, restored, saved, after, part

    fm = dit_model()
    f_opt = init_train_state(fm, adam)
    f_step = make_train_step(dit_cfg, objective="flow")
    f_losses = [f_step(fm, f_opt, t_batch, TRAIN_SEED) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    f_losses.append(no_sync("(c) flow: the third step", lambda: f_step(fm, f_opt, t_batch,
                                                                       TRAIN_SEED)))
    f_losses = torch.stack(f_losses).tolist()
    xf = torch.randn(SHAPE, generator=torch.Generator().manual_seed(284)).to(dev)
    flow_sig = torch.tensor([1.0, 0.75, 0.5, 0.25, 0.0])
    out_f = sample_sonar_euler_ancestral(
        make_dit_denoiser(fm, prediction="flow", timestep_fn=Flow().timestep), xf, flow_sig,
        seed=7, ancestral_mode="rf")
    need(all(math.isfinite(v) for v in f_losses) and out_f.shape == SHAPE
         and bool(torch.isfinite(out_f).all()), f"[28] (c) flow: losses {f_losses}")
    print(f"[28] (c) flow objective, 3 steps (the third under the sync check: no sync): losses "
          f"{[round(v, 5) for v in f_losses]}; the "
          f"trained weights served with prediction='flow', Flow().timestep, ancestral_mode='rf', "
          f"4 steps 1 -> 0: finite, std {float(out_f.std()):.4f}")
    del fm, f_opt, t_batch

    # (e) one training step of the flagship UNet, card against CPU on injected draws
    ug = torch.Generator().manual_seed(283)
    u_batch = torch.randn((2,) + SHAPE[1:], generator=ug)
    u_draw, e_draw = torch.rand(2, generator=ug), torch.randn(u_batch.shape, generator=ug)
    sgd0 = functools.partial(torch.optim.SGD, lr=0.0)
    u_step = make_train_step(cfg)
    res_e = {}
    torch.backends.cudnn.allow_tf32 = False
    with patched(TR, train_draws=lambda seed, b: (u_draw.to(b.device), e_draw.to(b.device))):
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            um = copy.deepcopy(model).to(d)
            lo = float(u_step(um, init_train_state(um, sgd0), u_batch.to(d), 0))
            res_e[side] = (lo, {k: p.grad.detach().cpu() for k, p in um.named_parameters()})
    torch.backends.cudnn.allow_tf32 = True
    (lo_g, g_g), (lo_c, g_c) = res_e["card"], res_e["cpu"]
    loss_rel_e = abs(lo_g - lo_c) / abs(lo_c)
    grad_rel_e = max(float((g_g[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                     for k, g in g_c.items())
    need(loss_rel_e <= 1e-5 and grad_rel_e <= 1e-4,
         f"[28] (e): loss {lo_g} against {lo_c}; gradients {grad_rel_e:.3e}")
    print(f"[28] (e) {cfg} one training step at {tuple(u_batch.shape)}, injected draws, TF32 off: loss "
          f"{lo_g:.7f} card, {lo_c:.7f} CPU ({loss_rel_e:.3e}); gradients within "
          f"{grad_rel_e:.3e} of each tensor's largest")
    del res_e
    print(json.dumps({"model_tier": {
        "dit_params_m": n_par / 1e6, "a_launches": l28a, "a": a_stats,
        "dit_forward_gflop": flops_fwd / 1e9, "dit_sampler_mfu_pct": mfu_wall,
        "dit_device_mfu_pct": mfu_dev, "a_peak_above_resident_gib": peak_a / 2**30,
        "a_kernel_vs_plain_rel": rel_kp, "a_card_vs_cpu_rel": rel_cc,
        "a_forward_blocks_rel": blk_rel_d, "a_forward_eps_rel": eps_rel, "a_bf16_rel": bf_rel,
        "b_routing_share": moe_share, "b_rest_rel": blk_rel, "b_whole_rel": whole_rel,
        "b_aux": float(aux_m), "b_steps_per_s": STEPS / (moe_ms / 1000), "c": train,
        "c_remat_grad_rel": remat_rel, "c_train_draws_b3_err": train_b3_err,
        "c_flow_losses": f_losses,
        "d_resume_loss": [loss_r, loss_u], "d_resume_rel": resume_rel,
        "d_resumed_step_syncs": resumed_syncs,
        "e_loss_rel": loss_rel_e, "e_grad_rel": grad_rel_e}}))
    print(f"[28] took {time.perf_counter() - t28:.0f} s; phases 1-28 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 29: the parallel tier's serving path ----------------------------------------
    print(f"[29] {time.perf_counter() - t_run:.0f} s into the run")
    t29 = time.perf_counter()
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from sonar_tpu_torch.models import (dit_apply, dit_param_shardings, dit_pp_apply,
                                        shard_dit_params)
    from sonar_tpu_torch.parallel import LatentShard, make_mesh, run_world, shard_latent

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    px0, pxd = (t.to(dev) for t in par_inputs(torch))
    n_loc = math.prod(SHAPE)  # one rank's shard of the parallel path's latent
    psig = torch.tensor(PAR_SIGMA, device=dev)
    pyr_cfg = SonarConfig(noise_type="pyramid")
    pyr_sig = sigmas[-PAR_PYR_STEPS - 1:]

    def sync_checked(what, fn, from_start=True):
        """``fn()`` under set_sync_debug_mode("error") (or from where ``fn``
        turns it on); the collectives lift it for their own span."""
        torch.cuda.synchronize()
        if from_start:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        except RuntimeError as e:
            fail(f"[29] {what} synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def dit_rel(a, b):
        """max |a - b| relative to max |b|: the init's 1e-2 head keeps a DiT
        output near 0.04, where max(1, |b|) would hide a wrong block."""
        return float((a.double() - b.double().to(a.device)).abs().max()) / float(
            b.double().abs().max())

    # the unsharded references, on the card
    ref_traj = sample_sonar_euler_ancestral(denoiser, px0, sigmas, seed=7)
    ref_pyr = sample_sonar_euler_ancestral(denoiser, px0, pyr_sig, seed=7, sonar_config=pyr_cfg)
    dense29 = dit_model()
    moe29 = dit_model(num_experts=4)
    with torch.no_grad():
        ref_eps = dense29(pxd, psig)
        ref_moe, ref_aux = moe29(pxd, psig, return_aux=True)

    # (a) a 1-rank NCCL world: every sharded entry with each mesh axis of size 1
    par = {"a": {}, "b": {}}
    launches_par = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh1 = make_mesh(axis_names=("dp",))
            xs1 = shard_latent(px0, mesh1)
            reset_counts()
            sharded = sync_checked("(a) the dp=1 sampler after its first model call",
                                   lambda: sample_sonar_euler_ancestral(
                                       Recorded(denoiser, sync_check=True), xs1, sigmas, seed=7),
                                   from_start=False)
            la = read_counts()
            need(la == {"B1": STEPS, "B2": 3 * STEPS, "B3": STEPS, "B4": 0, "B5": 0, "B6": 0,
                        "B7": att4 * STEPS}, f"[29] (a) dp=1 sampler launches {la}")
            need(type(sharded).__name__ == "DTensor" and sharded.placements == xs1.placements,
                 f"[29] (a) the result is not laid out as the latent: {type(sharded)}")
            par["a"]["flagship_rel"] = rel_err(sharded.to_local(), ref_traj)[1]
            reset_counts()
            pyr1 = sample_sonar_euler_ancestral(denoiser, xs1, pyr_sig, seed=7,
                                                sonar_config=pyr_cfg)
            lp = read_counts()
            need(lp["B4"] == PAR_PYR_STEPS and lp["B2"] == 3 * PAR_PYR_STEPS
                 and lp["B7"] == att4 * PAR_PYR_STEPS, f"[29] (a) dp=1 pyramid launches {lp}")
            par["a"]["pyramid_rel"] = rel_err(pyr1.to_local(), ref_pyr)[1]
            for k in counters:
                launches_par[k] += la[k] + lp[k]
            with torch.no_grad():
                m = make_mesh(axis_names=("tp",))
                local = shard_dit_params(dense29, m, dit_param_shardings(dense29, m))
                par["a"]["dit_tp_rel"] = dit_rel(sync_checked(
                    "(a) tp=1 forward", lambda: dit_apply(local, pxd, psig)), ref_eps)
                m = make_mesh(axis_names=("dp", "pp"))
                local = shard_dit_params(dense29, m, dit_param_shardings(dense29, m, tp=None,
                                                                         pp="pp"))
                par["a"]["dit_pp_rel"] = dit_rel(sync_checked(
                    "(a) dp=1 x pp=1 forward, 2 microbatches",
                    lambda: dit_pp_apply(local, shard_latent(pxd, m), psig, m,
                                         microbatches=2).to_local()), ref_eps)
                m = make_mesh(axis_names=("ep",))
                local = shard_dit_params(moe29, m, dit_param_shardings(moe29, m, tp=None))
                eps1, aux1 = sync_checked("(a) ep=1 forward",
                                          lambda: dit_apply(local, pxd, psig, return_aux=True))
                par["a"]["dit_ep_rel"] = dit_rel(eps1, ref_moe)
                par["a"]["dit_ep_aux"] = [float(aux1), float(ref_aux)]
            del local
        finally:
            dist.destroy_process_group()
    for key in ("flagship_rel", "pyramid_rel", "dit_tp_rel", "dit_pp_rel", "dit_ep_rel"):
        need(par["a"][key] <= PAR_TOL, f"[29] (a) {key} {par['a'][key]:.3e}")
    need(abs(par["a"]["dit_ep_aux"][0] - par["a"]["dit_ep_aux"][1]) <= 1e-6,
         f"[29] (a) aux {par['a']['dit_ep_aux']}")
    print(f"[29] (a) 1-rank NCCL world, each axis of size 1, against the unsharded runs (TF32 "
          f"off): flagship {PAR_SHAPE} {STEPS} steps on dp=1 {par['a']['flagship_rel']:.3e} "
          f"(launches {la}: B2 as its three split launches, B3 at a shard's indices; after its "
          f"first model call under set_sync_debug_mode('error')), pyramid {PAR_PYR_STEPS} "
          f"steps {par['a']['pyramid_rel']:.3e}; DiT-S/2 tp=1 {par['a']['dit_tp_rel']:.3e}, "
          f"dp=1 x pp=1 2 microbatches {par['a']['dit_pp_rel']:.3e}, MoE ep=1 "
          f"{par['a']['dit_ep_rel']:.3e} aux {par['a']['dit_ep_aux'][0]:.6f} (tolerance "
          f"{PAR_TOL:g}) [{card}]")

    # the new entries against their plain versions on the card, at the path's shard
    xs_loc = randn(SHAPE) * 1.7 + 0.3  # one rank's 1x4x64x64 of the 2x4x64x64 latent
    mo_k, mo_p = F.scale_noise_moments(xs_loc), F.scale_noise_moments_reference(xs_loc)
    mo2 = mo_k * 2  # two ranks' worth, as after the all_reduce
    m2_k, m2_p = F.scale_noise_m2(xs_loc, mo2), F.scale_noise_m2_reference(xs_loc, mo2)
    m2x2 = m2_k * 2
    ap_k = F.scale_noise_apply(xs_loc, mo2, m2x2, 1.5)
    ap_p = F.scale_noise_apply_reference(xs_loc, mo2, m2x2, 1.5)
    split_err = max(rel_err(mo_k, mo_p)[1], rel_err(m2_k, m2_p)[1], rel_err(ap_k, ap_p)[1])
    need(split_err <= B2_TOL, f"[29] B2 split against its plain versions: {split_err:.3e}")
    shard29 = (n_loc, n_loc, 2 * n_loc)  # rank 1's 1x4x64x64 of 2x4x64x64
    odd29 = (5, 4099, 8198)  # starts inside a Philox group, runs of an odd length
    b3s_err = 0.0
    for sh29 in (shard29, odd29):
        n29 = (sh29[1] * (2 if sh29 is odd29 else 1),)
        u_k = H.philox_rand(3, n29, device=dev, shard=sh29)
        need(torch.equal(u_k, H.philox_rand_reference(3, n29, device=dev, shard=sh29)),
             f"[29] B3 shard {sh29}: uniforms differ from the plain version")
        n_k = H.philox_randn(3, n29, device=dev, shard=sh29)
        b3s_err = max(b3s_err, float((n_k - H.philox_randn_reference(
            3, n29, device=dev, shard=sh29)).abs().max()))
        full29 = H.philox_randn(3, (sh29[0] + sh29[2] * 2,), device=dev)
        idx = H.shard_indices(n29[0], sh29, device=dev)
        need(torch.equal(n_k, full29[idx]), f"[29] B3 shard {sh29}: not the unsharded draw's slice")
    need(b3s_err <= B3_TOL, f"[29] B3 shard normals against plain: {b3s_err:.3e}")
    b4_ladder = G._size_ladder_pyramid(64, 64, 10, 0)
    b4s_err = 0.0
    # a plane slice of the path, and one whose planes (67 x 61) start off a Philox group
    for shp, planes in ((SHAPE, (4, 4, 8)), (SHAPE, (1, 1, 3)), ((1, 3, 67, 61), (1, 1, 2))):
        lad = G._size_ladder_pyramid(shp[2], shp[3], 10, 0)
        k4 = P.fused_pyramid(5, shp, lad, 0.7, device=dev, planes=planes)
        p4 = P.fused_pyramid_reference(5, shp, lad, 0.7, device=dev, planes=planes)
        b4s_err = max(b4s_err, rel_err(k4, p4)[1])
    need(b4s_err <= PYR_TOL, f"[29] B4 with a plane slice against plain: {b4s_err:.3e}")
    full4 = P.fused_pyramid(5, PAR_SHAPE, b4_ladder, 0.7, device=dev)
    need(rel_err(P.fused_pyramid(5, SHAPE, b4_ladder, 0.7, device=dev, planes=(4, 4, 8)),
                 full4[1:])[1] <= PYR_TOL, "[29] B4 rank 1's slice is not the unsharded draw's")
    par["a"]["errors"] = {"B2_split_rel": split_err, "B3_shard_normals_abs": b3s_err,
                          "B4_planes_rel": b4s_err}
    # device time a call at the path's shard, with the bound
    split_bd = b2_split_bounds(n_loc)
    new_entries = {
        "scale_noise_moments": (lambda: F.scale_noise_moments(xs_loc),
                                split_bd["scale_noise_moments"]),
        "scale_noise_m2": (lambda: F.scale_noise_m2(xs_loc, mo2), split_bd["scale_noise_m2"]),
        "scale_noise_apply": (lambda: F.scale_noise_apply(xs_loc, mo2, m2x2, 1.5),
                              split_bd["scale_noise_apply"]),
        "philox_randn shard": (lambda: H.philox_randn(3, SHAPE, device=dev, shard=shard29),
                               b3_bound(n_loc)),
        "fused_pyramid planes": (lambda: P.fused_pyramid(5, SHAPE, b4_ladder, 0.7, device=dev,
                                                          planes=(4, 4, 8)),
                                 b4_bound(SHAPE, b4_ladder, "bilinear", gen=True)),
    }
    par["a"]["device_us"] = {}
    for nm, (fn, bd) in new_entries.items():
        us, by = device_us(torch, fn, 50)
        if nm == "fused_pyramid planes":  # the B4 kernel alone, not its B3 levels
            us = sum(v for k_, v in by.items() if "pyramid_up_kernel" in k_)
        par["a"]["device_us"][nm] = {"us": us, "bound_us": bd["us"], "bound_by": bd["by"]}
        print(f"[29] {nm} at the path's shard {SHAPE}: {fmt_us(us)} a call on the device, "
              f"bound {bd['us']:.2f} us by {bd['by']} [{card}]")
    print(f"[29] B2 split (moments, m2, apply) against its plain versions {split_err:.3e}; B3 "
          f"at a shard's indices {shard29} and {odd29}: uniforms bitwise, normals within "
          f"{b3s_err:.3e} of plain and bit-equal to the unsharded kernel draw's slice; B4 on a "
          f"plane slice {b4s_err:.3e}, rank 1's slice of the 2x4x64x64 draw")

    # (b) two ranks of a gloo world sharing the card
    t_b = time.perf_counter()
    ranks = run_world(par_world, 2, backend="gloo", device_type="cuda")
    world_s = time.perf_counter() - t_b
    ranks31 = [r.pop("p31") for r in ranks]  # [31] (b), read in phase 31
    dp_traj = torch.from_numpy(np.concatenate([r["dp_traj"] for r in ranks]))
    pyr_traj = torch.from_numpy(np.concatenate([r["pyr_traj"] for r in ranks]))
    par["b"] = {
        "world_s": world_s,
        "flagship_rel": rel_err(dp_traj, ref_traj.cpu())[1],
        "pyramid_rel": rel_err(pyr_traj, ref_pyr.cpu())[1],
        "dit_tp_rel": max(dit_rel(torch.from_numpy(r["tp"]), ref_eps.cpu()) for r in ranks),
        "dit_pp_rel": max(dit_rel(torch.from_numpy(r["pp"]), ref_eps.cpu()) for r in ranks),
        "dit_dp_rel": dit_rel(torch.from_numpy(np.concatenate([r["dp"] for r in ranks])),
                              ref_eps.cpu()),
        "dit_ep_rel": max(dit_rel(torch.from_numpy(r["ep"][0]), ref_moe.cpu()) for r in ranks),
        "dit_ep_aux": [r["ep"][1] for r in ranks] + [float(ref_aux)],
        "draws": [r["draws"] for r in ranks],
        "launches": {r["rank"]: {"dp": r["dp_launches"], "pyramid": r["pyr_launches"]}
                     for r in ranks},
        "collectives_per_step": {r["rank"]: r["collectives_per_step"] for r in ranks},
        "dp_run_s": [r["dp_s"] for r in ranks],
    }
    for r in ranks:
        need(r["dp_placements"] == "(Shard(dim=0),)", f"[29] (b) placements {r['dp_placements']}")
        need(r["draws"]["uniforms_bitwise"] and r["draws"]["normals_vs_slice"] == 0.0
             and r["draws"]["normals_vs_plain"] <= B3_TOL
             and r["draws"]["sampler_draw_rel"] <= PAR_TOL, f"[29] (b) draws {r['draws']}")
        need(r["dp_launches"] == {"B1": STEPS, "B2": 3 * STEPS, "B3": STEPS, "B4": 0,
                                  "B7": att4 * STEPS},
             f"[29] (b) rank {r['rank']} dp launches {r['dp_launches']}")
        need(r["pyr_launches"]["B4"] == PAR_PYR_STEPS
             and r["pyr_launches"]["B7"] == att4 * PAR_PYR_STEPS,
             f"[29] (b) rank {r['rank']} pyramid launches {r['pyr_launches']}")
        for k in ("B1", "B2", "B3", "B4", "B7"):
            launches_par[k] += r["dp_launches"][k] + r["pyr_launches"][k]
    for key in ("flagship_rel", "pyramid_rel", "dit_tp_rel", "dit_pp_rel", "dit_dp_rel",
                "dit_ep_rel"):
        need(par["b"][key] <= PAR_TOL, f"[29] (b) {key} {par['b'][key]:.3e}")
    need(max(abs(a - float(ref_aux)) for a in par["b"]["dit_ep_aux"][:2]) <= 1e-6,
         f"[29] (b) aux {par['b']['dit_ep_aux']}")
    print(f"[29] (b) 2-rank gloo world, both ranks on the one card ({world_s:.1f} s with the "
          f"ranks' start): flagship dp=2 {par['b']['flagship_rel']:.3e} against (a)'s unsharded "
          f"batch-2 run, pyramid dp=2 {par['b']['pyramid_rel']:.3e}; each rank's draws its slice "
          f"of the unsharded draw (uniforms bitwise, normals bit-equal to the kernel's slice); "
          f"DiT-S/2 tp=2 {par['b']['dit_tp_rel']:.3e}, pp=2 2 microbatches "
          f"{par['b']['dit_pp_rel']:.3e}, dp=2 x pp=1 {par['b']['dit_dp_rel']:.3e}, MoE ep=2 "
          f"{par['b']['dit_ep_rel']:.3e} aux {par['b']['dit_ep_aux']} (tolerance {PAR_TOL:g})")
    for r in ranks:
        print(f"[29] (b) rank {r['rank']}: launches dp run {r['dp_launches']}, pyramid run "
              f"{r['pyr_launches']}; collectives a step (count, ms by host clock between "
              f"synchronisations) {r['collectives_per_step']}; the 20-step dp run took "
              f"{r['dp_s']:.3f} s. Two processes time-slice one card: not a speed [{card}]")
    par["launches_parallel"] = launches_par
    print(json.dumps({"parallel": par}, default=float))
    del dense29, moe29
    print(f"[29] took {time.perf_counter() - t29:.0f} s; phases 1-29 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 30: the parallel tier's training half ---------------------------------------
    print(f"[30] {time.perf_counter() - t_run:.0f} s into the run")
    t30 = time.perf_counter()
    from sonar_tpu_torch.parallel import shard_unet_params, unet_param_shardings

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ucfg30 = UNetConfig()
    step_u30 = make_train_step(ucfg30)
    batch30 = t30_batch(torch).to(dev)

    def cpu_tree(named):
        return {k: v.detach().to("cpu", copy=True) for k, v in named}

    def unsharded(model, step, seed=TRAIN30_SEED, opt=None):
        opt = opt or init_train_state(model, adam)
        reset_counts()
        loss = float(step(model, opt, batch30, seed))
        got = read_counts()
        grads = cpu_tree((k, p.grad) for k, p in model.named_parameters())
        return opt, got, {"loss": loss, "grads": grads,
                          "grads_max": {k: float(g.abs().max()) for k, g in grads.items()},
                          "params1": cpu_tree(model.named_parameters())}

    # the unsharded steps on the card: the flagship UNet and DiT-S/2 at 8x4x64x64
    unet30 = init_unet_params(torch.Generator().manual_seed(0), ucfg30, device=dev)
    att30 = attention_blocks(unet30)
    opt30, l_ref, ref_unet = unsharded(unet30, step_u30)
    need(l_ref == {"B1": 0, "B2": 0, "B3": 2, "B4": 0, "B5": 0, "B6": 0, "B7": att30},
         f"[30] the unsharded step's launches {l_ref}")
    ckpt30 = os.path.join(ROOT, "build", "ckpt30")
    save_checkpoint(ckpt30, {"params": unet30.state_dict(), "opt_state": opt30.state_dict(),
                             "step": 1}, force=True)
    _, _, ref_resumed = unsharded(unet30, step_u30, TRAIN30_RESUME_SEED, opt30)
    del unet30, opt30
    dit30 = dit_model()
    step_d30 = make_train_step(dit_cfg)
    _, _, ref_dit = unsharded(dit30, step_d30)
    del dit30
    ref_path = os.path.join(ROOT, "build", "ref30.pt")
    torch.save({"unet": ref_unet, "dit": ref_dit,
                "resumed": {k: ref_resumed[k] for k in ("loss", "grads", "grads_max")}}, ref_path)

    # (a) a 1-rank NCCL world: each sharded step with every axis of size 1
    pt = {"a": {}, "b": {}}
    launches_pt = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message=NO_AUTOGRAD)
                for key in ("unet_tp1", "unet_fsdp_dp1", "dit_tp1", "dit_pp1"):
                    if key.startswith("unet"):
                        m = make_mesh(axis_names=("dp", "tp"), mesh_shape=(1, 1))
                        fs = key == "unet_fsdp_dp1"
                        model = init_unet_params(torch.Generator().manual_seed(0), ucfg30,
                                                 device=dev)
                        local = shard_unet_params(model, m, fsdp=fs)
                        whole_of = WholeOf(m, unet_param_shardings(model, m, fsdp=fs))
                        step, xb, ref = step_u30, shard_latent(batch30, m), ref_unet
                    else:
                        pp = key == "dit_pp1"
                        m = make_mesh(axis_names=("pp",) if pp else ("tp",))
                        model = dit_model()
                        local = shard_dit_params(model, m, dit_param_shardings(
                            model, m, tp=None if pp else "tp", pp="pp" if pp else None))
                        whole_of = WholeOf(stage_blocks=0)
                        step = (make_train_step(dit_cfg, pp_mesh=m, microbatches=2) if pp
                                else step_d30)
                        xb, ref = batch30, ref_dit
                    del model
                    opt = init_train_state(local, adam)
                    reset_counts()
                    loss = float(step(local, opt, xb, TRAIN30_SEED))
                    got = read_counts()
                    # B7: the layout's forwards (two microbatches under pp)
                    need(b1_b6(got) == b1_b6(l_ref) and got["B7"] > 0,
                         f"[30] (a) {key}: launches {got}, expected {l_ref} but for B7")
                    for k in counters:
                        launches_pt[k] += got[k]
                    res = {"loss": loss, "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                           **t30_check(torch, local, whole_of, ref)}
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:  # the collectives lift the check for their own span
                        step(local, opt, xb, TRAIN30_SEED)
                    except RuntimeError as e:
                        fail(f"[30] (a) {key}: a second step synchronised with the host: {e}")
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    pt["a"][key] = res
                    del local, opt
        finally:
            dist.destroy_process_group()
    for key, res in pt["a"].items():
        need(res["loss_rel"] <= TRAIN30_LOSS_TOL and res["grad_rel"] <= TRAIN30_GRAD_TOL
             and res["adam_bound_ratio"] <= 1.0, f"[30] (a) {key}: {res}")
    print(f"[30] (a) 1-rank NCCL world, each axis of size 1, one step against the unsharded "
          f"step on the card (flagship UNet and DiT-S/2, {TRAIN30_BATCH}, Adam {TRAIN30_LR:g}, "
          f"seed {TRAIN30_SEED}, TF32 off): "
          + "; ".join(f"{k} loss {v['loss_rel']:.3e}, gradients {v['grad_rel']:.3e}, weights "
                      f"{v['max_dp_over_lr']:.3e} lr (Adam bound ratio {v['adam_bound_ratio']:.3f})"
                      for k, v in pt["a"].items())
          + f"; launches a step {l_ref}; a second step of each under "
          f"set_sync_debug_mode('error'): no sync outside the collectives [{card}]")

    # (b) and (c): two gloo ranks sharing the card
    t_b = time.perf_counter()
    ranks = run_world(par_train_world, 2, backend="gloo", device_type="cuda",
                      args=(ref_path, ckpt30))
    pt["b"]["world_s"] = time.perf_counter() - t_b
    for r in ranks:
        for key in ("dp2", "tp2", "fsdp_dp2", "dit_pp2"):
            res = r[key]
            ref = ref_dit if key == "dit_pp2" else ref_unet
            res["loss_rel"] = abs(res["loss"] - ref["loss"]) / abs(ref["loss"])
            need(res["loss_rel"] <= TRAIN30_LOSS_TOL and res["grad_rel"] <= TRAIN30_GRAD_TOL
                 and res["adam_bound_ratio"] <= 1.0, f"[30] (b) rank {r['rank']} {key}: {res}")
            need(b1_b6(res["launches"]) == b1_b6(l_ref) and res["launches"]["B7"] > 0,
                 f"[30] (b) rank {r['rank']} {key}: launches {res['launches']}")
            need(res["sync_checked"], f"[30] (b) rank {r['rank']} {key}: no sync-checked step")
        d = r["dp2"]["draws"]
        need(d["uniforms_bitwise"] and d["normals_vs_slice"] <= B3_TOL
             and d["normals_vs_plain_slice"] <= B3_TOL, f"[30] (b) rank {r['rank']} draws {d}")
        c = r["restore"]
        c["loss_rel"] = abs(c["loss"] - ref_resumed["loss"]) / abs(ref_resumed["loss"])
        need(c["bit_equal"] and c["loss_rel"] <= TRAIN30_LOSS_TOL
             and c["grad_rel"] <= TRAIN30_GRAD_TOL and c["update_mismatched"] == 0,
             f"[30] (c) rank {r['rank']}: {c}")
        for k in counters:
            launches_pt[k] += r["launches"][k]
    rep_bytes = ranks[0]["dp2"]["state_bytes"]
    pt["b"]["ranks"] = ranks
    pt["b"]["bytes_vs_replicated"] = {k: [r[k]["state_bytes"] / rep_bytes for r in ranks]
                                      for k in ("tp2", "fsdp_dp2")}
    for r in ranks:
        print(f"[30] (b) rank {r['rank']} of a 2-rank gloo world on the one card "
              f"({pt['b']['world_s']:.1f} s with the ranks' start): "
              + "; ".join(f"{k} loss {r[k]['loss_rel']:.3e}, gradients {r[k]['grad_rel']:.3e}, "
                          f"weights {r[k]['max_dp_over_lr']:.3e} lr (bound ratio "
                          f"{r[k]['adam_bound_ratio']:.3f}), params + Adam "
                          f"{r[k]['state_bytes'] / 2**20:.1f} MiB, collectives a step "
                          f"{r[k]['collectives']}"
                          for k in ("dp2", "tp2", "fsdp_dp2", "dit_pp2"))
              + f"; draws {r['dp2']['draws']}; a step of each under "
              f"set_sync_debug_mode('error'): no sync outside the collectives. Two processes "
              f"time-slice one card: not a speed [{card}]")
        print(f"[30] (c) rank {r['rank']}: the unsharded checkpoint restored onto the FSDP "
              f"layout (dp=2) in {r['restore']['restore_s']:.2f} s, every block bit-equal to "
              f"its slice: {r['restore']['bit_equal']}; the resumed step: loss "
              f"{r['restore']['loss_rel']:.3e}, gradients {r['restore']['grad_rel']:.3e} from "
              f"the resumed unsharded step, its update Adam's on the gathered gradients "
              f"({r['restore']['update_mismatched']} of {r['restore']['elements']} weights "
              f"differ)")
    shutil.rmtree(ckpt30)
    os.remove(ref_path)
    pt["launches_parallel_train"] = launches_pt
    print(json.dumps({"parallel_train": pt}, default=float))
    print(f"[30] took {time.perf_counter() - t30:.0f} s; phases 1-30 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 31: every sampler and every noise type on a sharded latent ------------------
    print(f"[31] {time.perf_counter() - t_run:.0f} s into the run")
    t31 = time.perf_counter()
    from torch.distributed.tensor import DTensor

    from sonar_tpu_torch.noise.presets import noise_type_names

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names31 = list(noise_type_names())
    need(len(names31) == P31_NAMES, f"[31] {len(names31)} noise names, not {P31_NAMES}")
    p31 = {"a": {}, "b": {}}
    launches31 = {k: 0 for k in counters}
    b5_planes_launches = 0
    a_sig = bench_sigmas(torch, P31_STEPS)

    # (a) a 1-rank NCCL world: every registry name and every noise name on a dp=1 shard
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh31 = make_mesh(axis_names=("dp",))
            xs31 = shard_latent(x0, mesh31)
            sh31 = LatentShard.of(xs31)
            samp_rel, collectives31 = {}, {}
            real_ar = dist.all_reduce
            n_ar = [0]

            def count_ar(*a, **kw):
                n_ar[0] += 1
                return real_ar(*a, **kw)

            for nm in sorted(REGISTRY):
                fn = REGISTRY[nm]
                ref = fn(denoiser, x0, a_sig, seed=7)
                rec = SyncFrom(torch, denoiser, check=nm != "dpm_adaptive")
                reset_counts()
                n_ar[0] = 0
                with patched(dist, all_reduce=count_ar):
                    got = p31_checked(torch, f"(a) {nm} on dp=1",
                                      lambda: fn(rec, xs31, a_sig, seed=7))
                lc = read_counts()
                for k in counters:
                    launches31[k] += lc[k]
                need(isinstance(got, DTensor) and got.placements == xs31.placements,
                     f"[31] (a) {nm}: the result is not laid out as the latent")
                samp_rel[nm] = rel_err(got.to_local(), ref)[1]
                collectives31[nm] = n_ar[0]
            p31["a"]["samplers_rel"] = samp_rel
            need(max(samp_rel.values()) <= PAR_TOL, f"[31] (a) samplers on dp=1 {samp_rel}")
            need(not any(collectives31.values()),
                 f"[31] (a) a 1-rank world made collectives {collectives31}")
            noise_rel, synced_s, synced_u = {}, [], []
            for nm in names31:
                reset_counts()
                got, syn = p31_noise(torch, get_noise_item(nm), SHAPE, dev, sh31)
                lc = read_counts()
                for k in counters:
                    launches31[k] += lc[k]
                b5_planes_launches += lc["B5"]
                ref, syn_u = p31_noise(torch, get_noise_item(nm), SHAPE, dev)
                noise_rel[nm] = max(rel_err(g, r)[1] for g, r in zip(got, ref))
                synced_s += [nm] if syn else []
                synced_u += [nm] if syn_u else []
            p31["a"]["noise_rel"] = noise_rel
            p31["a"]["noise_synced"] = {"sharded": synced_s, "unsharded": synced_u}
            need(max(noise_rel.values()) <= PAR_TOL, f"[31] (a) noise on dp=1 {noise_rel}")
            need(set(synced_s) <= set(synced_u),
                 f"[31] (a) the shard adds a host read to {sorted(set(synced_s) - set(synced_u))}")
        finally:
            dist.destroy_process_group()
    worst_s = max(samp_rel, key=samp_rel.get)
    worst_n = max(noise_rel, key=noise_rel.get)
    print(f"[31] (a) 1-rank NCCL world: all {len(REGISTRY)} registry names on a dp=1 shard of "
          f"{cfg} {SHAPE}, {P31_STEPS} steps, against their unsharded runs (TF32 off): max rel "
          f"{samp_rel[worst_s]:.3e} ({worst_s}; each from its first model call under "
          f"set_sync_debug_mode('error'), dpm_adaptive's host read exempt; no collective call); "
          f"all {len(names31)} noise names, two draws each: max rel {noise_rel[worst_n]:.3e} "
          f"({worst_n}; tolerance {PAR_TOL:g}); a third draw read the card back for "
          f"{synced_u or 'none'} unsharded and {synced_s or 'none'} sharded [{card}]")

    # B5 with planes= against its plain version and the unsharded kernel draw's slice
    hl512 = G._size_ladder_highres(*P31_B5_BIG[2:], 4, 0)
    hc512 = [0.7**i for i in range(len(hl512))]
    ol64 = [(SHAPE[2] * 2 ** (i + 1), SHAPE[3] * 2 ** (i + 1)) for i in range(5)]
    b5p_err = 0.0
    cases31 = (  # shape, planes, ladder, mode, base: rank 1's planes of 2x4x64x64, and
        # every other plane of a 67 x 61 field (its slices start inside Philox groups)
        (SHAPE, (4, 4, 8), hl64, "bilinear", True),
        (SHAPE, (4, 4, 8), ol64, "nearest-exact", False),
        ((1, 3, 67, 61), (1, 1, 2), G._size_ladder_highres(67, 61, 4, 0), "bilinear", True))
    for shp, planes, lad, mode, with_base in cases31:
        need(P.fused_downscale_supported(lad, shp[2], shp[3], mode),
             f"[31] B5 ladder {lad} in mode {mode} is not B5's")
        cf = [0.7**i for i in range(len(lad))]
        i5 = torch.arange(shp[1], device=dev)
        idx = planes[0] + (i5 // planes[1]) * planes[2] + i5 % planes[1]
        full_shape = (1, int(idx.max()) + 1, shp[2], shp[3])
        base = randn(shp) if with_base else None
        full_base = None
        if with_base:
            full_base = randn(full_shape)
            full_base[:, idx] = base
        for variant in (1, 2):
            with P._forced_down_variant(variant):
                k5 = P.fused_downscale_pyramid(5, shp, lad, cf, mode, base=base, device=dev,
                                               planes=planes)
                full5 = P.fused_downscale_pyramid(5, full_shape, lad, cf, mode,
                                                  base=full_base, device=dev)
            p5 = P.fused_downscale_pyramid_reference(5, shp, lad, cf, mode, base, device=dev,
                                                     planes=planes)
            b5p_err = max(b5p_err, rel_err(k5, p5)[1])
            need(torch.equal(k5, full5[:, idx]),
                 f"[31] B5 planes {planes} (kernel {variant}): not the unsharded draw's slice")
    need(b5p_err <= PAR_TOL, f"[31] B5 with planes= against plain: {b5p_err:.3e}")
    big_base = randn(P31_B5_BIG)
    big_planes = (16, 16, 32)  # rank 1's 4x4x512x512 of 8x4x512x512
    b5p_us = {}
    for key, fn, bd in (
            ("1x4x64x64", lambda: P.fused_downscale_pyramid(5, SHAPE, hl64, hc64, base=pbase,
                                                            device=dev, planes=(4, 4, 8)),
             b5_bound(P, SHAPE, hl64, hc64, "bilinear", base=True)),
            ("1x4x64x64 plain", lambda: P.fused_downscale_pyramid_reference(
                5, SHAPE, hl64, hc64, "bilinear", pbase, device=dev, planes=(4, 4, 8)), None),
            ("4x4x512x512", lambda: P.fused_downscale_pyramid(
                5, P31_B5_BIG, hl512, hc512, base=big_base, device=dev, planes=big_planes),
             b5_bound(P, P31_B5_BIG, hl512, hc512, "bilinear", base=True))):
        us, _ = device_us(torch, fn, 50 if "512" not in key else 10)
        b5p_us[key] = {"us": us, **({} if bd is None else {"bound_us": bd["us"],
                                                           "bound_by": bd["by"]})}
        print(f"[31] B5 planes= at {key}: {fmt_us(us)} a call on the device"
              + ("" if bd is None else f", bound {bd['us']:.2f} us by {bd['by']}") + f" [{card}]")
    p31["a"]["b5_planes"] = {"err_rel": b5p_err, "device_us": b5p_us}
    print(f"[31] B5 with planes= (both kernels; rank 1's planes and a slice starting inside a "
          f"Philox group) against its plain version {b5p_err:.3e} (tolerance {PAR_TOL:g}) and "
          f"bit-equal to the unsharded kernel draw's slice")

    # (b) [29]'s 2-rank gloo world: each rank's block against the unsharded run on the card
    b_sig = bench_sigmas(torch, P31_B_STEPS)
    b_rel = {}
    for nm in P31_B_SAMPLERS:
        ref = REGISTRY[nm](denoiser, px0, b_sig, seed=7, **p31_sampler_kw(nm))
        got = torch.from_numpy(np.concatenate([r["samplers"][nm][0] for r in ranks31]))
        b_rel[nm] = rel_err(got, ref.cpu())[1]
    unet31 = init_unet_params(torch.Generator().manual_seed(0), cfg, device=dev)  # [4]'s
    with torch.no_grad():
        gref = p31_guided(torch, unet31)()(px0, b_sig)
    del unet31
    b_rel["guided"] = rel_err(torch.from_numpy(np.concatenate(
        [r["samplers"]["guided"][0] for r in ranks31])), gref.cpu())[1]
    calls_dpm = [r["samplers"]["dpm_adaptive"][2] for r in ranks31]
    need(len(set(calls_dpm)) == 1, f"[31] (b) dpm_adaptive's ranks made {calls_dpm} model calls")
    for r in ranks31:
        need(all(v[1] == "(Shard(dim=0),)" for v in r["samplers"].values()),
             f"[31] (b) placements {[v[1] for v in r['samplers'].values()]}")
    need(max(b_rel.values()) <= PAR_TOL, f"[31] (b) samplers on dp=2 {b_rel}")
    nb_rel = {}
    for nm in names31:
        ref, _ = p31_noise(torch, get_noise_item(nm), PAR_SHAPE, dev)
        nb_rel[nm] = max(
            rel_err(torch.from_numpy(r["noise"][nm][i]),
                    ref[i][tuple(slice(o, o + n) for o, n in zip(*r["box"]))].cpu())[1]
            for r in ranks31 for i in range(len(ref)))
    need(max(nb_rel.values()) <= PAR_TOL, f"[31] (b) noise blocks on dp=2 {nb_rel}")
    vref, _ = p31_noise(torch, p31_video_item(), VIDEO_SHAPE, dev, sigmas=P31_VIDEO_SIGMAS)
    v_rel = max(rel_err(torch.from_numpy(r["video"]["draws"][i]),
                        vref[i][tuple(slice(o, o + n) for o, n in zip(*r["video"]["box"]))]
                        .cpu())[1] for r in ranks31 for i in range(len(vref)))
    need(v_rel <= PAR_TOL, f"[31] (b) video noise with frames on sp: {v_rel:.3e}")
    for r in ranks31:
        need(set(r["noise_synced"]) <= set(synced_u),
             f"[31] (b) the shard adds a host read to {r['noise_synced']}")
        for k in launches31:
            launches31[k] += sum(v.get(k, 0) for v in r["launches"].values())
        b5_planes_launches += r["launches"]["noise"].get("B5", 0)
    p31["b"] = {"samplers_rel": b_rel, "noise_rel": nb_rel, "video_rel": v_rel,
                "launches": [r["launches"] for r in ranks31],
                "collectives_per_step": [r["collectives_per_step"] for r in ranks31],
                "model_calls": [{k: v[2] for k, v in r["samplers"].items()} for r in ranks31],
                "noise_synced": [r["noise_synced"] for r in ranks31]}
    worst_b = max(nb_rel, key=nb_rel.get)
    print(f"[31] (b) 2-rank gloo world on the one card, {PAR_SHAPE} on dp=2, {P31_B_STEPS} "
          f"steps against the unsharded runs (TF32 off): "
          f"{ {k: float(f'{v:.2e}') for k, v in b_rel.items()} } (each from its first model "
          f"call under set_sync_debug_mode('error'), dpm_adaptive exempt; dpm_adaptive's "
          f"ranks made {calls_dpm} model calls); every noise name's block, max rel "
          f"{nb_rel[worst_b]:.3e} ({worst_b}); config 5's video noise {VIDEO_SHAPE} with its "
          f"frames on sp=2 {v_rel:.3e} (tolerance {PAR_TOL:g})")
    for i, r in enumerate(ranks31):
        print(f"[31] (b) rank {i}: launches {r['launches']}; collectives a step "
              f"{r['collectives_per_step']}. Two processes time-slice one card: not a speed "
              f"[{card}]")
    p31["launches_parallel_noise"] = launches31
    p31["b5_planes_launches"] = b5_planes_launches
    need(b5_planes_launches > 0, "[31] B5 with planes= was not launched on a sharded path")
    for k in counters:
        launches_par[k] += launches31[k]
    print(json.dumps({"sharded_all": p31}, default=float))
    print(f"[31] took {time.perf_counter() - t31:.0f} s; phases 1-31 took "
          f"{time.perf_counter() - t_run:.0f} s")

    # -- phase 32: kernel B7, the attention core, at the main path's shapes ---------------
    print(f"[32] {time.perf_counter() - t_run:.0f} s into the run")

    att32 = {}
    for label, layout, b, n, heads, d, tf32 in ATT_SHAPES:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        qkv = randn((b, n, 3 * heads * d)).unflatten(
            -1, (3, heads, d) if layout == "unet" else (heads, 3, d))
        which = 2 if layout == "unet" else 3
        q, k, v = (qkv.select(which, i).transpose(1, 2) for i in range(3))  # (b, heads, n, d)
        w0 = AT.fused_attention.wgmma_launches
        out, plain = AT.fused_attention(qkv, layout), AT.attention_reference(qkv, layout)
        torch.cuda.synchronize()
        tile = ("wgmma" if AT.fused_attention.wgmma_launches > w0
                else "mma" if tf32 else "ffma")  # the tile the wrapper chose
        err = float((out - plain).abs().max())
        rms = float(plain.square().mean().sqrt())
        tol = ATT_TOL[tf32]
        need(err <= tol * rms, f"[32] {label}: kernel against plain {err:.3e} over RMS "
             f"{rms:.3e} (tolerance {tol:g} of the RMS)")
        # device time a call (torch.profiler), as the other kernels' rows
        times = {}
        for what, fn, iters in (
                ("kernel", lambda: AT.fused_attention(qkv, layout), 10),
                ("plain", lambda: AT.attention_reference(qkv, layout), 3),
                ("library", lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                 3)):
            us, by = device_us(torch, fn, iters)
            need(us is not None and (what != "kernel" or len(by) == 1),
                 f"[32] {label}: {what}'s device time not measured ({by})")
            times[what] = us / 1000
        ms, plain_ms, lib_ms = times["kernel"], times["plain"], times["library"]
        flops = 4.0 * b * heads * n * n * d
        t_ops, t_bytes = flops / ATT_PEAK[tf32], 4.0 * 4 * b * n * heads * d / HBM_BYTES_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        att32[label] = {"shape": [b, n, heads, d], "tf32": tf32, "tile": tile,
                        "max_abs_err": err, "rms": rms, "ms": ms, "bound_ms": bound_ms,
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "tflop_s": flops / ms / 1e9, "plain_ms": plain_ms, "library_ms": lib_ms}
        print(f"[32] {label} {b}x{n}x{heads}x{d} ({'TF32' if tf32 else 'FFMA'}, tile {tile}): "
              f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} ms "
              f"({att32[label]['bound_by']}), {100 * bound_ms / ms:.1f} % of it; plain "
              f"{plain_ms:.3f} ms, library_ms (scaled_dot_product_attention) {lib_ms:.3f} ms; "
              f"max |kernel - plain| {err:.3e} (RMS {rms:.3e}) [{card}]")
        del qkv, q, k, v, out, plain
    torch.backends.cuda.matmul.allow_tf32 = False
    need(launches["B7"] > 0 and l27a["B7"] > 0 and l28a["B7"] > 0,
         "the attention kernel was not launched on the main paths")
    print(json.dumps({"attention": att32}))

    src = "sonar_tpu_torch/csrc/"
    n_el = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    rows = [
        ("fused_momentum_step", "fused.cu", "sonar_tpu/kernels/fused.py:68",
         launches["B1"], b1_err, "B1", b1_bound(n_el)),
        ("fused_scale_noise", "fused.cu", "sonar_tpu/kernels/fused.py:173",
         launches["B2"], b2_err, "B2", b2_bound(n_el)),
        ("philox_randn", "hwrng.cu", "sonar_tpu/kernels/hwrng.py:63",
         path_launches["B3"], b3_err, "B3", b3_bound(n_el)),
        ("fused_pyramid", "fused_pyramid.cu", "sonar_tpu/kernels/fused_pyramid.py:100",
         path_launches["B4"], b4_err, "B4", b4_bound(SHAPE, ladder, "bilinear", gen=True)),
        ("fused_downscale_pyramid", "fused_pyramid.cu",
         "sonar_tpu/kernels/fused_pyramid.py:264",
         sum(c["B5"] for c in down_launches.values()), b5_err, "B5",
         b5_bound(P, SHAPE, hl64, hc64, "bilinear", base=True)),
        ("voronoi_ksmallest", "voronoi.cu", "sonar_tpu/kernels/voronoi.py:78",
         vor_launches["B6"], b6_err, "B6", b6_bound(SHAPE, 256, 2)),
    ]
    for kname, _, _, n_launch, _, k, _ in rows:
        need(n_launch > 0, f"{kname} was not launched on its path")
        need(all(v is not None and v > 0 for v in dev_timing[k]),
             f"{kname}: device time not measured")
    # B5 with a shard's planes: its launches on [31]'s sharded paths, its
    # device time at one rank's 1x4x64x64 (and 4x4x512x512) beside its bound
    b5p_bd = b5_bound(P, SHAPE, hl64, hc64, "bilinear", base=True)
    b5p_row = {"name": "fused_downscale_pyramid planes", "route": "cuda",
               "source": src + "fused_pyramid.cu",
               "replaces": "sonar_tpu/kernels/fused_pyramid.py:264",
               "launches": b5_planes_launches, "max_abs_err": b5p_err,
               "ms": b5p_us["1x4x64x64"]["us"] / 1000,
               "plain_ms": b5p_us["1x4x64x64 plain"]["us"] / 1000,
               "bound_ms": b5p_bd["us"] / 1000, "bound_by": b5p_bd["by"], "library_ms": None,
               "ms_4x4x512x512": b5p_us["4x4x512x512"]["us"] / 1000,
               "bound_ms_4x4x512x512": b5p_us["4x4x512x512"]["bound_us"] / 1000}
    need(all(b5p_row[k] is not None and b5p_row[k] > 0 for k in ("ms", "plain_ms")),
         "fused_downscale_pyramid planes: device time not measured")
    def on_paths(k):
        """Kernel ``k``'s launches on each path, each from its own run."""
        return {
         "launches_dpmpp_sde": sde_launches[k], "launches_config3": p3_launches[k],
         "launches_config3_sdxl": l19[k], "launches_config2_sdxl": l21["config2"][k],
         "launches_config4_sdxl": l21["config4"][k], "launches_config5_video": l22[k],
         "launches_registry": reg_launches[k],
         "launches_registry_sdxl": sum(l24[nm][k] for nm in names24),
         "launches_combinators": sum(l25[t][k] for t in "ABC"),
         "launches_config5_zwalk": lz[k],
         "launches_noise_zoo_rest": sum(l26[z][k] for z in l26),
         "launches_dtcwt_wcfg_sdxl": l26d[k],
         "launches_workflow": l27a[k] + l27b[k],
         "launches_dit": l28a[k], "launches_train": l28c[k],
         "launches_parallel": launches_par[k], "launches_parallel_train": launches_pt[k],
         "launches_sharded_all": launches31[k]}

    a0 = att32["sd1 level 0"]
    att_row = {"name": "fused_attention", "route": "cuda", "source": src + "attention.cu",
               "replaces": None, "launches": launches["B7"],
               "max_abs_err": a0["max_abs_err"], "ms": a0["ms"], "plain_ms": a0["plain_ms"],
               "bound_ms": a0["bound_ms"], "bound_by": a0["bound_by"],
               "library_ms": a0["library_ms"], **on_paths("B7"), "shapes": att32}
    # ms, plain_ms, library_ms: device time per call at the path's shape
    # (torch.profiler); call_ms, plain_call_ms: CUDA events, host cost included
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": n_launch, "max_abs_err": e, "ms": dev_timing[k][0] / 1000,
         "plain_ms": dev_timing[k][1] / 1000, "bound_ms": bd["us"] / 1000,
         "bound_by": bd["by"],
         "library_ms": library_us[k] / 1000 if k in library_us else None,
         "call_ms": timing[k][0], "plain_call_ms": timing[k][1], **on_paths(k)}
        for kname, f, rep, n_launch, e, k, bd in rows] + [b5p_row, att_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
