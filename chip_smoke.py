#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`caffeonspark_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # the whole check
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

It exits non-zero, printing no result, when no CUDA device is visible
or the package is not importable, and when any phase fails.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (nvcc, all sources at once), with
     the registers and spills (`-Xptxas -v`) of each flash kernel and of
     lrn.cu's backward kernels (K2's instantiations, K4's and its d_bias
     sum), and
     beside it the native ingest library from native/ (g++: the byte
     moves, and the libjpeg decoders where the machine has libjpeg); a
     line says whether libjpeg, cv2 and PIL are there;
  3. each kernel against its plain PyTorch version on the card: the forward
     kernels at the serving path's B=64 shapes (f32, and bf16 for the LRN
     kernels) and at the training path's B=256 shapes, the LRN backward
     kernels (K2, K4) at the B=256 shapes in f32 and bf16 (K4 also at
     GoogLeNet's (32,192,56,56)) and at a ragged shape, K4's d_bias against
     the exact sum of its dx and against the plain version's, K4 twice
     (byte-equal) and in a CUDA graph (byte-equal to the eager call), its
     share of the byte bound, and the fused backward through
     BiasReluLRNAcrossChannels against K4's dx-only build followed by the
     separate dx.float().sum((0, 2, 3)), K1-K4 at local_size 13 and at N = 65,600
     (untimed), the flash attention kernels (K6 forward, K7 dq, K8 dk/dv)
     at the LM's (B*H, T, D) = (64, 2048, 64), causal and not, f32 and
     bf16, at (64, 2048, 128) f32 causal, at the sp ring's backward call
     (64, 512, 64) bf16 in, f32 gradients out, causal and not, at head_dim
     256 (16, 2048, 256) and head_dim 512 (8, 2048, 512; the wide kernels),
     f32 and bf16, causal and not (with each output's error against float64
     beside the plain version's), and at ragged (3, 200, 48), (4, 384, 32),
     (4, 384, 200), (3, 200, 257), (2, 130, 320) and (2, 96, 1024), with
     kernel / plain / library / bound times (the bound on the kernels'
     tensor-core route, 3xTF32 or bf16, beside the f32 SIMT figure), each
     kernel run twice (bit-equal results, two launches counted); K5 twice
     per shape and once more after its timed calls, exact each time; K9
     (the ring hop) at the sp ring's per-rank (B*H, Tq, Tk, D) = (64, 512,
     512, 64), f32 and bf16: the diagonal causal hop (q_off = k_off = 512),
     a fully visible causal hop (q_off 1536, k_off 0) and a non-causal hop,
     each from the ring's first carry (timed: kernel / plain / bound) and
     from a mid-ring carry, then the ragged (3, 200, 328, 48) at q_off 100,
     k_off 150, whose first rows see no key, causal and not, at head_dim
     256 (16, 512, 512, 256) and 512 (8, 512, 512, 512) on a diagonal and a
     full causal hop (timed), and at ragged D 200, 257, 320 and 1024, each
     hop run twice (bit-equal);
  4. a full-width CaffeNet .caffemodel (227x227, 60,965,224 params)
     written with the port's own save_caffemodel and seeded fillers;
  5. that model served through the CLI's start_server (-serve path),
     answering /v1/predict over HTTP; rows held against the same
     forward with every kernel swapped for its plain version;
  6. the same for AlexNet under COS_FUSE_BIAS_RELU_LRN=1 and
     COS_SERVE_WEIGHT_DTYPE=int8 (launch counts of phases 5-6 zeroed
     before phase 5 and read after phase 6);
  7. one B=64 flush per net under torch.profiler: device busy time
     against the flush's wall time;
  8. training data: an LMDB of 512 seeded 3x256x256 Datum records
     written with the port's LmdbWriter, and train_val-style prototxts
     of full-width CaffeNet and AlexNet (B=256, random 227 crop, mirror,
     mean_value; the bvlc_reference_caffenet SGD solver cut to
     max_iter 8, snapshot 4);
  9. both trained through the CLI (`caffe_on_spark.main([... -train])`,
     the default ingest: a pool of 2 pack threads and a stager thread on
     a side stream; counts zeroed before each, read after): the first
     loss near ln 1000, every loss finite, snapshots at 4 and 8 and the
     final model, K1+K2 (CaffeNet) and K3+K4 (AlexNet,
     COS_FUSE_BIAS_RELU_LRN=1) each launched 2 x max_iter times; median
     step time and images/s over steps 3-8; then the ingest runs:
     CaffeNet for 32 steps without snapshots at COS_TRANSFORM_THREADS=0,
     at the default 2, at 2 with COS_DEVICE_TRANSFORM=1 (the native
     crop/mirror) and at 2 with COS_DEVICE_TRANSFORM=1 COS_NATIVE=0 (the
     numpy crop) and at 2 with COS_DEVICE_TRANSFORM=1
     COS_STEPS_PER_LOOP=4 (CUDA graphs of 4 steps) (cuDNN
     deterministic): the first 4 packed batches bit-equal between 0 and
     2 threads and across the device-transform runs, the device stage
     (run on the card) within 1e-5 of the host transform, every step's
     loss within 1e-5 relative across the five;
     for each the median step interval over steps 3-8 and the steady
     step time over steps 9-32, images/s and p50 pack; the native
     crop/mirror at (256, 3, 256, 256), crop 227, bit-equal to the numpy
     host stage, both timed; the feeder's rate (LMDB read and Datum
     parse on one thread);
     validating training: the stock train_val shape, a TEST data layer
     of B=50 (center crop 227, mean_value) on a second LMDB of 100
     seeded records, the solver cut to max_iter 8, test_interval 4,
     test_iter 2, for CaffeNet and AlexNet (COS_FUSE_BIAS_RELU_LRN=1):
     two validation.json rounds of finite accuracy and loss, K1 (K3)
     launched 2 x 8 + 2 rounds x 2 batches x 2 LRN layers = 24 times,
     K2 (K4) 16; then -test and -features fc8 of the trained CaffeNet
     over the 100 TEST records through the CLI, K1 4 launches each, the
     means and the fc8 rows within 1e-4 of the all-plain run's max, the
     -test means within 1e-6 of the last validation round's (the same
     records and weights);
 10. one solver step's loss and gradients with the kernels against the
     same step with every kernel swapped for its plain version (same
     params, batch and dropout seed; cuDNN deterministic);
 11. the trained CaffeNet served through start_server (finite fc8 rows);
 12. one training step per net under torch.profiler;
 13. the zoo's causal transformer LM at d_model 1024, 16 heads, 2
     layers, vocab 1000, T 2048, batch 4: 64 seeded JSON rows of 2,049
     tokens read by a DataFrameSource, trained through the CLI for 8
     Adam steps (counts zeroed before, read after): first loss near
     ln 1000, every loss finite, snapshots at 4 and 8, K6, K7 and K8
     each launched layers x max_iter = 16 times, median step time and
     tokens/s over steps 3-8; one step against the plain step; one
     step under torch.profiler, with the flash kernels' share;
 14. the same LM, rows and solver on an sp4 mesh, trained through the
     CLI with `-mesh 1,1,4` for 8 steps (counts zeroed before, read
     after): the ring attention, its 4 ranks on the one card (512 time
     steps each); first loss near ln 1000, every loss finite, snapshots
     at 4 and 8, K9 (the ring's forward hops), K7 and K8 (its backward
     pairs) each launched layers x 10 x max_iter = 160 times and K6
     never; one sp step against the same step with every kernel plain
     (loss 1e-5, gradients LM_STEP_GRAD_TOL), with only K9 plain against
     the all-plain step (gradients STEP_GRAD_TOL: the backward kernels
     in the ring) and against the single-device kernel step of phase 13
     (loss 1e-5, gradients LM_STEP_GRAD_TOL); 5 synchronized direct
     steps; one step under torch.profiler, with K9's and the flash
     kernels' share of the busy time;
 15. the LM with 4 heads of 256 (d_model 1024, the zoo's transformer_lm
     at heads 4), same rows and solver, trained through the CLI for 8
     steps (counts zeroed before, read after): K6, K7 and K8 at head_dim
     256, 16 launches each; one step against the all-plain step (loss
     1e-5, gradients LM_STEP_GRAD_TOL) and the step with only K6 plain
     (STEP_GRAD_TOL); 5 synchronized direct steps; one profiled step;
 16. the same at 2 heads of 512 (the zoo's transformer_lm at heads 2):
     K6, K7 and K8 through their wide kernels, 16 launches each;
 17. the standalone trainer, `mini_cluster.main` (counts zeroed before
     each run, read after): CaffeNet at B=256 with -dtype float32 and
     mixed, AlexNet (COS_FUSE_BIAS_RELU_LRN=1) mixed, 8 steps each with
     -metrics every step, a snapshot at 4 and the final model; every
     loss finite, the first near ln 1000; K1 / K2 (K3 / K4) 16 launches
     each, all in bf16 under mixed (counted by dtype); the mixed first
     loss within MIXED_VS_F32_LOSS_RTOL of the f32 one; each mixed net's step
     against the same step with every kernel plain (loss
     MIXED_STEP_LOSS_RTOL, gradients MIXED_STEP_GRAD_TOL);
 18. COS_STATE_DTYPE=bfloat16 on the CaffeNet SGD solver through
     mini_cluster: 4 steps, snapshot, resume from the step-4 solverstate
     to 6; the momentum in bf16 after both, the params f32;
 19. the LM through mini_cluster in float32, mixed and bfloat16 (8 Adam
     steps each, K6-K8 16 launches each, in bf16 under mixed and
     bfloat16), their first losses against the float32 run's; per dtype 5
     synchronized direct steps and one step under torch.profiler (busy
     time, idle share, the GEMMs' and flash's shares, the host's CUDA
     runtime calls); the mixed step against the step with K6-K8 plain;
     -mesh 1,1,4 -dtype mixed for
     MC_ITERS_SP steps (K9, K7, K8 in bf16) and one sp mixed step
     against the single-device mixed step and the all-plain step;
 20. encoded records: an LMDB of 512 seeded 3x256x256 images encoded as
     JPEG with the machine's encoder (cv2, else PIL); CaffeNet -train on
     it for 8 steps under cuDNN deterministic (first loss near ln 1000,
     every loss finite, K1 / K2 16 launches each), one batch's decode
     timed, the uint8 decode equal
     to the float decode cast; without libjpeg the native decoder's
     refusal naming it (the records then go through cv2); without an
     encoder, the refusal of an encoded record naming what is missing;
 21. COS_STEPS_PER_LOOP=4: the LM through mini_cluster in float32, mixed
     and bfloat16 for 8 steps (display 4: an eager warm-up chunk, then
     the captured CUDA graph's replay; K6-K8 16 launches each, replays
     counted), each final model bit-equal to phase 19's K=1 run; per
     dtype 5 synchronized direct chunks (a step = chunk / 4) and one
     replayed chunk under torch.profiler; sp4 mixed at K=2 for 4 steps
     against the same run at K=1 (final models bit-equal);
 22. validating CaffeNet through the CLI at COS_STEPS_PER_LOOP=4 and 1,
     16 steps, test_interval 8, snapshot 6 (the chunks 4, 1, 1, 1, 1, 4,
     4), cuDNN deterministic: losses, validation rounds and launches
     equal, the snapshots at 6 and 12 and the final model byte-equal;
     then 5 synchronized direct CaffeNet steps (f32, B=256) against 5
     synchronized graphed chunks of 4;
 23. GoogLeNet (bvlc_googlenet with its two TRAIN-only auxiliary
     towers; the published xavier conv fillers) at B=32, random 224
     crop of the 256x256 records, mirror, mean_value, the quick_solver
     (SGD 0.01, poly 0.5, momentum 0.9, weight_decay 2e-4) cut to 8
     steps, snapshot 4, through the CLI: K1 + K2 on norm1 (32,64,56,56)
     and norm2 (32,192,56,56), 16 launches each; then with
     COS_FUSE_BIAS_RELU_LRN=1, where the peephole folds conv2/3x3's bias
     and relu into norm2: K1 + K2 and K3 + K4, 8 launches each; each
     step against the all-plain step; K1-K3 timed at these shapes;
 24. ResNet-50 at the same data shape, SGD 0.1, momentum 0.9,
     weight_decay 1e-4, 8 steps through the CLI: the 53 BatchNorm
     layers' running statistics finite and moved, the step against the
     plain step, -test of the trained model (global statistics) over
     the 100 TEST records against the CPU's -test of the same model;
     the same for a model trained at lr 1e-4, whose statistics fit its
     weights, with its TEST loss in the first-loss band; mini_cluster f32 at
     COS_STEPS_PER_LOOP=1 and 4 (cuDNN deterministic; the final model
     and the step-4 snapshot byte-equal) and 2 steps -dtype mixed
     against 2 steps f32 (first loss within MIXED_VS_F32_LOSS_RTOL),
     every BatchNorm of the mixed net fed and computing in f32; 5
     synchronized direct steps of each of the three nets;
 25. write-behind snapshots: VGG-16 (B=32, SGD 0.01, momentum 0.9,
     weight_decay 5e-4) and the LM of phase 13, each 8 steps with
     snapshots at 4 and 8 through the CLI synchronously and with
     -async_snapshot (cuDNN deterministic): snapshots and final model
     byte-equal, losses equal; the wall time of each snapshot call on
     the solver thread and the host interval holding the step-4
     snapshot against the others;
 26. HDF5: CaffeNet 2 steps with snapshot_format HDF5 and BINARYPROTO,
     each resumed with -snapshot from its step-2 state to 4: the two
     final models equal (cuDNN deterministic); where h5py is missing,
     the refusal naming it before any step;
 27. the quant sidecar: AlexNet (COS_FUSE_BIAS_RELU_LRN=1,
     COS_SERVE_WEIGHT_DTYPE=int8) loaded from its f32 model (parse,
     quantization, drift gate; timed), `<model>.quant` exported, a
     second registry loaded from the sidecar (timed) with equal resident
     blobs and rows, then served through start_server from the sidecar
     (counts zeroed before, read after: K5 on fc6-fc8), rows against the
     plain path;
 28. the zoo's lstm_lm at lrcn_cos.prototxt's widths (vocab 8801,
     embedding and LSTM 1000, T 20, B 32; 25,614,801 params) on 256 JSON
     rows that the port's image_caption_to_embedding builds from seeded
     synthetic captions (8-20 words of 9,000 word forms; the Vocab built
     to 8801), trained through the CLI for 8 steps under LRCN's solver
     (SGD 0.01, momentum 0.9, step 0.5 / 20,000, clip_gradients 10;
     counts zeroed before, read after: no kernel): the first loss near
     ln 8801, every loss finite, snapshots at 4 and 8; the card's first
     step against the CPU port's on the same params and batch (loss
     LSTM_CPU_LOSS_RTOL, gradients LSTM_CPU_GRAD_TOL); mini_cluster in
     float32, mixed and bfloat16 (mixed and bfloat16's first loss
     within MIXED_VS_F32_LOSS_RTOL of f32's), each again at
     COS_STEPS_PER_LOOP=4 with its final model byte-equal to K=1's; per
     dtype 5 synchronized direct steps, 5 synchronized graphed chunks,
     one profiled step and one profiled chunk;
 29. captions: CaffeNet -features fc8 of 32 seeded 3x256x256 records
     (the validated CaffeNet; counts zeroed before, read after: K1 on
     norm1 and norm2, 2 launches); the rows feed the captioner of
     tests/test_lrcn.py at lrcn_cos widths (vocab 8801, embedding and
     LSTM 1000, fc8 as the LSTM's static input), trained 8 steps through
     the CLI; the 32 images decoded with greedy_caption,
     incremental_greedy_caption and beam_caption (beam 3), each timed;
     greedy against incremental equal wherever both steps' top-1 /
     top-2 margins exceed NEAR_TIE; the stepper's first step on the card
     against the CPU's (STEPPER_CPU_TOL);
 30. every new stateless layer type forward and backward on the card
     against the CPU port (the activations and MVN at (32, 256, 28, 28),
     the losses at (256, 1000), FCN-32s's Deconvolution + Crop head,
     SPP of pyramid 3 at (32, 256, 13, 13), STOCHASTIC pooling's TEST
     mean; LAYER_TOP_TOL / LAYER_GRAD_TOL) and STOCHASTIC pooling's
     TRAIN pick frequencies over 512k windows (STOCHASTIC_FREQ_TOL);
 31. the rest of the data path: phase 20's 512 JPEG Datums (its run,
     under cuDNN deterministic, is the reference) in the LMDB's key
     order through every other store into full-width CaffeNet, each
     through the CLI (counts zeroed before, read after): (a) image files
     converted by the converters CLI's binary2sequence into a part
     directory, SeqImageDataSource, -train for 8 steps with a TEST layer
     on a SequenceFile (lmdb2sequence of the 100 TEST records; K1 24, K2
     16), then -test (K1 4); (b) a LevelDB with snappy blocks written by
     the port's LevelDBWriter, a source-less Data layer with backend
     LEVELDB, -train (K1 / K2 16); (a) and (b) under cuDNN deterministic,
     their first packed batches bit-equal and final models byte-equal to
     the reference's; (c) finetune_flickr_style (ImageData of B 50 over
     the image files, labels mod 20, fc8_flickr) with -weights of (a)'s
     model, every layer but fc8_flickr copied before step 1, first loss
     near ln 20 (K1 24, K2 16); (d) a JSON-lines DataFrame of base64
     images (binary2dataframe) through a CoSData ENCODED_IMAGE top, inline
     packing, its first packed batch equal to the CPU port's; (e)
     HDF5Data, ImageDataFrame and binary2dataframe to .parquet refused by
     name where h5py / pyarrow are missing (run where present); each
     reader alone in records a second, and each run's median step
     interval, pack p50 and wall beside the reference's;
 32. dp and tp ranks sharing the card (`parallel.ParallelSolver`), under
     cuDNN deterministic, counts zeroed before each run: CaffeNet at the
     global B=256 through the CLI at -mesh 1 and 2 (the validating
     config; validation rounds within ROWS_F32_TOL of the max of dp 1's)
     and -mesh 4 (without validation: the TEST batch of 50 does not
     divide over 4), K1 / K2 launched dp times dp 1's, every loss within
     DP_LOSS_RTOL of dp 1's; AlexNet under COS_FUSE_BIAS_RELU_LRN=1 at
     -mesh 1 and 2 (K3 / K4); -mesh 4 under COS_ZERO=1 (losses within
     ZERO_LOSS_RTOL of plain dp 4's; each rank's optimizer-state bytes,
     fc6 and fc7 at a quarter); -mesh 2 at COS_STEPS_PER_LOOP=4
     (byte-equal to eager dp 2); these runs write no snapshot (the
     card's disk counts every byte written); the first step's reduced
     gradients at dp 2 and 4 no farther from the float64 step's than
     twice dp 1's distance plus DP_GRAD_TOL of the max, and
     synchronized direct steps by dp; -test and -features fc8 under
     -mesh 2 within ROWS_F32_TOL of dp 1's; the LM through mini_cluster
     -dtype mixed at -mesh 2,2 (K6 / K7 / K8 once per (B/2, H/2) block,
     4 times dp 1's a step; losses within LM_STEP_GRAD_TOL) and -mesh
     2,1,2 (K9 and K7 / K8: the sp 2 ring once per dp row); the f32
     LM's first-step reduced gradients at -mesh 2,2 and 2,1,2 held as
     CaffeNet's, and planted faults (rank 1's gradient dropped, tp
     blocks joined in reverse) rejected; ep, pp, -serve -mesh and a tp
     axis across processes (mini_cluster -cluster 2 -mesh 1,2) refused
     by name (phase 3 also checks K1-K4 at the
     ranks' shapes, K6-K8 at (16, 2048, 64) bf16 and K9 at
     (32, 1024, 1024, 64));
 33. the gradient exchange (`parallel/gradsync.py`, COS_GRAD_SYNC) over
     the dp ranks, direct steps under cuDNN deterministic: CaffeNet at
     the global B=256, dp 2 and 4, under default, bucket, hier, quant
     (bf16 wire) and quant with an int8 wire, 8 steps each: each plan's
     comm_info (243,860,896 f32 bytes a rank), the first step's reduced
     gradients (bucket / hier byte-equal to default's, bf16 the rounded
     sum, int8 within one quantum), losses and final params (bucket /
     hier byte-equal, quant within GS_LOSS_RTOL / GS_PARAM_TOL), K1 / K2
     launches equal to default's, the median of 5 synchronized steps;
     bucket at dp 4 under COS_ZERO=1 and bucket, quant and quant int8
     at dp 2 as CUDA graphs of 4, byte-equal to their references; one
     profiled bucket step (the first bucket's reduction issued before
     conv1's backward); the f32 LM at -mesh 2,2 under bucket (its tp
     blocks skipped) byte-equal to default, K6-K8 launches equal;
 34. data-parallel training across processes: CaffeNet at the global
     B=256 as two processes sharing the card (`mini_cluster -server
     127.0.0.1:<port> -cluster 2 -rank I`, gloo; each process K1 / K2
     once a step, half of one process's -mesh 2), under cuDNN
     deterministic: under hier byte-equal to one process's -mesh 2; ZeRO-1
     to step 4 with its `.shard<k>` sidecars, read back, and a resume to
     8 on two processes byte-equal to the same resume in one; -devices 2
     (dp 4) within DP_LOSS_RTOL / MP_PARAM_TOL of one process's -mesh 4,
     and byte-equal to it with its sums associated as two processes'
     ((r0 + r1) + (r2 + r3));
     each collective of `parallel.comm` on CUDA tensors across the
     processes (its route: gloo) against its sum; the median of 5
     synchronized direct steps under default, bucket and hier with
     COS_GRAD_OVERLAP on and off, beside one process's dp 2 (every
     mode's losses and params byte-equal to it); a `multiproc` JSON
     line;
 35. the tp and sp axes across processes: two processes sharing the
     card, each holding half of the global mesh (`mini_cluster -cluster
     2 -mesh ...`), each against one process with the same -mesh: the
     full-width LM at -mesh 1,1,2 (the ring's hop across processes) and
     1,2 (head and column blocks), 4 f32 steps, byte-equal, the two
     processes' K9 / K7 / K8 summing to one process's in the causal
     ring's 1 : 2 and 2 : 1 shares (K6 / K7 / K8 on (B·H/2, T, D) blocks
     half each), each one's bytes of the split blobs and their state
     half; CaffeNet B 256 at -mesh 2,2 byte-equal, its snapshot at 4
     (rank 0's dense model, `.shard0/.shard1`) read back and resumed to
     8 on two processes and one, byte-equal; the validating CaffeNet at
     -mesh 1,2 (rank 0's validation.json within MPM_VAL_TOL, rank 1's
     none); the median of 5 synchronized direct steps of both LM meshes
     beside one process's, the gloo bytes a step of the hops and joins,
     whether gloo's send / recv take CUDA tensors; a `multiproc_mesh`
     JSON line;
 36. a `kernels` JSON line: launches on the serving, image-net training,
     ingest, validating training, -test, -features, LM training, sp LM
     training, head_dim-256 and -512 LM training, mini_cluster (those by
     dtype; graphed runs included), encoded and graphed CaffeNet,
     GoogLeNet, ResNet-50, snapshot, HDF5, sidecar, lstm_lm, caption
     (features, captioner, decode), layer, data-path, dp, gradient
     exchange, multi-process and multi-process mesh paths, and the
     numbers of phase 3 (K1-K4 also at GoogLeNet's shapes in the
     `kernel_records` line); a `ptxas` line; then the card line again;
 37. the device line, last: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import urllib.request
import zlib

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # tf32 tensor cores, dense; K7/K8 take f32
                               # inputs as 3xTF32: three products each
BF16_OPS_PER_S = 989e12        # bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12       # int8 tensor cores, dense
L2_BYTES = 50 * 2**20
SLEEP_CYCLES = 200_000_000     # ~0.1 s at the H100's ~1.98 GHz boost
B = 64                         # the serving path's largest bucket
TRAIN_B = 256                  # the training path's batch
TRAIN_ITERS = 8

LRN_RTOL, LRN_ATOL = 2e-5, 2e-6          # f32, as tests/test_pallas.py
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6   # one bf16 ulp of the output
BWD_RTOL, BWD_ATOL = 3e-4, 3e-5          # f32 backward, tests/test_pallas.py
STEP_LOSS_RTOL = 1e-5  # kernel vs plain solver step: loss
STEP_GRAD_TOL = 1e-4   # ... and each gradient, of its max |grad|
# The LM's step: K6's online softmax rounds O differently from the plain
# full softmax (max abs err 9.5e-7 at the LM's shapes), and the FFN's
# ReLUs flip on pre-activations that close to 0, moving ff*/weight and
# ff*/bias gradients by up to 5.7e-3 of their max, embed/weight by
# 1.7e-3 (measured on an H100 by this script; with only K6 swapped for
# its plain version every gradient equalled the plain step's, so the
# backward kernels are held to STEP_GRAD_TOL in the net separately)
LM_STEP_GRAD_TOL = 2e-2
ROWS_F32_TOL = 1e-4    # max |served - plain| / max |plain|, f32 net
ROWS_INT8_TOL = 1e-2   # int8: a flipped rounding moves 1/127 of a max
# flash attention (K6-K8) against its plain version, whose matmuls sum
# in another order: tests/test_pallas.py:210, 236; bf16 one bf16 ulp of
# the output beyond that (both round the same f32 math once)
FLASH_FWD_TOL = 2e-5
FLASH_GRAD_RTOL, FLASH_GRAD_ATOL = 2e-4, 1e-5
FLASH_BH, FLASH_T, FLASH_D = 64, 2048, 64   # the LM's (B*H, T, head_dim)
FLASH_NEG_HALF = -5e29    # at or below: a row that has seen no key (m_safe)
SP = 4                    # the sp ring's ranks, all on the one card
SP_T_LOCAL = FLASH_T // SP
# the transformer LM: the zoo's vocab and depth, heads/head_dim/T of
# scripts/bench_attention.py:56, batch 4 (8,192 tokens a step)
LM = dict(vocab=1000, d_model=1024, heads=16, layers=2, seq=2048, batch=4)
# the same LM with 4 heads of 256 (the zoo's transformer_lm at d_model
# 1024, heads 4; the head width of published LMs such as Gemma 7B)
LM256 = dict(LM, heads=4)
# and with 2 heads of 512 (heads past the padded-width kernels' 256: the
# wide kernels)
LM512 = dict(LM, heads=2)
LM_ROWS = 64
# mini_cluster's -dtype mixed / bfloat16 against float32 or against the
# same step with the kernels plain.  The kernel and its plain version
# round the same f32 math to bf16 once each, so they part only where a
# value sits at a rounding tie; a bf16 loss blob moves by whole ulps, so
# the loss is held to one ulp (2^-7 relative at most) and the gradients,
# which pass such a difference on through the bf16 backward and the
# ReLUs, to MIXED_STEP_GRAD_TOL of their largest element.  The mixed run
# against the f32 run from the same weights, batches and dropout draws:
# the first step's loss to 2^-5 relative (two ulps of a bf16 loss near
# ln 1000); later steps part as the trajectories do, and are recorded.
MIXED_STEP_LOSS_RTOL = 2.0 ** -7
MIXED_STEP_GRAD_TOL = 5e-2
MIXED_VS_F32_LOSS_RTOL = 2.0 ** -5
MC_ITERS_SP = 2          # mini_cluster's sp4 mixed run: steps
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")

PALLAS = "caffeonspark_tpu/ops/pallas_kernels.py"
KERNELS = {  # `library`: the one PyTorch call timed as library_ms
    "lrn_across_channels": dict(
        source="caffeonspark_tpu_torch/csrc/lrn.cu",
        replaces=f"{PALLAS}:113", library="F.local_response_norm"),
    "lrn_across_channels_bwd": dict(
        source="caffeonspark_tpu_torch/csrc/lrn.cu",
        replaces=f"{PALLAS}:155",
        library="torch.autograd.grad of F.local_response_norm"),
    "bias_relu_lrn_across_channels": dict(
        source="caffeonspark_tpu_torch/csrc/lrn.cu",
        replaces=f"{PALLAS}:228", library=None),
    "bias_relu_lrn_across_channels_bwd": dict(
        source="caffeonspark_tpu_torch/csrc/lrn.cu",
        replaces=f"{PALLAS}:267", library=None),
    "int8_matmul": dict(
        source="caffeonspark_tpu_torch/csrc/int8_matmul.cu",
        replaces=f"{PALLAS}:352", library="torch._int_mm"),
    "flash_attention_fwd": dict(
        source="caffeonspark_tpu_torch/csrc/flash_attn.cu",
        replaces=f"{PALLAS}:598",
        library="F.scaled_dot_product_attention"),
    "flash_attention_bwd_dq": dict(
        source="caffeonspark_tpu_torch/csrc/flash_attn.cu",
        replaces=f"{PALLAS}:656",
        library="autograd backward of F.scaled_dot_product_attention "
                "(dq, dk, dv; against K7 + K8)"),
    "flash_attention_bwd_dkv": dict(
        source="caffeonspark_tpu_torch/csrc/flash_attn.cu",
        replaces=f"{PALLAS}:666",
        library="autograd backward of F.scaled_dot_product_attention "
                "(dq, dk, dv; against K7 + K8)"),
    "flash_block_update": dict(
        source="caffeonspark_tpu_torch/csrc/flash_attn.cu",
        replaces=f"{PALLAS}:773",
        library=None),  # no one PyTorch call folds a block into a carry
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets, iters: int = 20):
    """(device ms per call, host us per call) over `iters` calls after 3
    warm-up calls.  A sleep kernel holds the stream while the host
    enqueues every call, so the CUDA events bracket back-to-back device
    work, not the Python launch path (whose cost per call is the second
    number).  Calls cycle through `arg_sets`, which the caller sizes past
    the 50 MB L2, so every call reads its operands from device memory
    as a serving flush does."""
    import torch
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / iters
    check(host_s < 0.9 * SLEEP_CYCLES / 1.98e9,
          f"enqueue took {host_s:.3f} s, longer than the sleep that "
          "should hide it: the timing would include host time")
    return dev_ms, 1e6 * host_s / iters


def rotations(nbytes: int) -> int:
    return max(2, math.ceil(3 * L2_BYTES / max(1, nbytes)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def lrn_ops_per_elem(local_size: int, relu: bool, bias: bool) -> int:
    # local_size squares + (local_size - 1) adds, then scale = k + c*s
    # (2), log, *(-beta), exp, *x (4); +1 for relu, +1 for bias
    return 2 * local_size + 5 + int(relu) + int(bias)


def check_lrn(K, torch, name, shape, dtype, relu, bias, results, ls=5,
              timed=True):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"{name}{shape}{dtype}{relu}{ls}".encode()))
    x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=g)
    alpha, beta, k = 1e-4, 0.75, 1.0
    if bias:
        run = lambda x, b: K.bias_relu_lrn_across_channels(  # noqa: E731
            x, b, ls, alpha, beta, k)
        plain = lambda x, b: K.lrn_plain(  # noqa: E731
            x, ls, alpha, beta, k, bias=b)
    else:
        run = lambda x, b: K.lrn_across_channels(  # noqa: E731
            x, ls, alpha, beta, k, relu)
        plain = lambda x, b: K.lrn_plain(  # noqa: E731
            x, ls, alpha, beta, k, relu)
    got = run(x, b)
    torch.cuda.synchronize()
    want = plain(x, b)
    err = (got.float() - want.float()).abs()
    rtol, atol = ((LRN_RTOL, LRN_ATOL) if dtype == torch.float32
                  else (BF16_RTOL, BF16_ATOL))
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    check(not bool(bad.any()),
          f"{name} {shape} {dtype} local_size {ls}: {int(bad.sum())} "
          f"elements outside rtol {rtol} atol {atol} (max abs err "
          f"{max_err:.3g})")
    # y is the plain version's bit for bit in both dtypes (csrc/lrn.cu
    # `staged::lrn_y`, `lrn_y_bf16`)
    exact = bool(torch.equal(got, want))
    check(exact, f"{name} {shape} {dtype} local_size {ls}: not bit-equal "
                 f"to the plain version (max abs err {max_err:.3g})")
    if not timed:
        results.setdefault(name, []).append(dict(
            shape=list(shape), dtype=str(dtype).replace("torch.", ""),
            relu=relu, local_size=ls, max_abs_err=max_err,
            bit_equal=exact))
        log(f"  {name} {tuple(shape)} {str(dtype).replace('torch.', '')} "
            f"relu={relu} local_size {ls}: max_abs_err {max_err:.3g} "
            f"bit-equal {exact}")
        return
    nbytes = 2 * x.numel() * x.element_size() + (4 * shape[1] if bias
                                                 else 0)
    sets = [(x.clone(), b.clone()) for _ in range(rotations(nbytes))]
    ms, host_us = time_ms(run, sets)
    plain_ms, _ = time_ms(plain, sets)
    lib_ms = None
    if not relu and not bias:
        lib = lambda x, b: F.local_response_norm(  # noqa: E731
            x, ls, alpha, beta, k)
        lib_ms, _ = time_ms(lib, sets)
    ops = x.numel() * lrn_ops_per_elem(ls, relu or bias, bias)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    plan = K._lrn_launch_plan(x, ls, 3 if bias else 1, int(relu or bias))
    rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               relu=relu, max_abs_err=max_err, bit_equal=exact, ms=ms,
               host_us=host_us, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               plan=plan._asdict())
    rec["share_of_bound"] = rec["bound_ms"] / ms
    results.setdefault(name, []).append(rec)
    log(f"  {name} {tuple(shape)} {rec['dtype']} relu={relu}: "
        f"max_abs_err {max_err:.3g} (rtol {rtol:.3g} atol {atol:.3g}, "
        f"bit-equal) kernel {ms:.4f} ms (launch path {host_us:.1f} us on "
        f"the host) plain {plain_ms:.4f} ms library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}): "
        f"{rec['share_of_bound']:.3f} of the bound; tile {plan.tile}, run "
        f"{plan.run} ({plan.runs} runs, {plan.waves:.2f} waves)")


def lrn_bwd_ops_per_elem(local_size: int, relu: bool, bias: bool) -> int:
    # s: local_size squares + (local_size - 1) adds + 2; s^-beta: log,
    # mul, exp (3); u: 2 muls + div (3); dy*s^-beta (1); the window sum
    # of u (local_size - 1); dx: 2 muls + sub (3); +1 relu, +1 bias
    return 3 * local_size + 10 + int(relu) + int(bias)


def check_lrn_bwd(K, torch, name, shape, dtype, relu, results, timed=True,
                  ls=5):
    """K2 against lrn_bwd_plain on the same x and dy."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"{name}{shape}{dtype}{relu}{ls}".encode()))
    x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=g)
    alpha, beta, k = 1e-4, 0.75, 1.0
    run = lambda x, dy, b: K.lrn_across_channels_bwd(  # noqa: E731
        x, dy, ls, alpha, beta, k, relu)
    plain = lambda x, dy, b: K.lrn_bwd_plain(  # noqa: E731
        x, dy, ls, alpha, beta, k, relu)
    got = run(x, dy, b)
    torch.cuda.synchronize()
    want = plain(x, dy, b)
    err = (got.float() - want.float()).abs()
    rtol, atol = ((BWD_RTOL, BWD_ATOL) if dtype == torch.float32
                  else (BF16_RTOL, BF16_ATOL))
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    exact = bool(torch.equal(got, want))
    check(not bool(bad.any()),
          f"{name} {shape} {dtype} local_size {ls}: {int(bad.sum())} "
          f"elements outside rtol {rtol} atol {atol} (max abs err "
          f"{max_err:.3g})")
    # f32 dx is the plain version's bit for bit (K2 shares its formula
    # with K4, and the fused AlexNet step is held to 1e-4)
    check(exact or dtype != torch.float32,
          f"{name} {shape} {dtype} local_size {ls}: not bit-equal to the "
          f"plain version (max abs err {max_err:.3g})")
    rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               relu=relu, local_size=ls, max_abs_err=max_err,
               bit_equal=exact)
    if not timed:
        log(f"  {name} {tuple(shape)} {rec['dtype']} relu={relu} "
            f"local_size {ls}: max_abs_err {max_err:.3g} bit-equal {exact}")
        results.setdefault(name, []).append(rec)
        return
    nbytes = 3 * x.numel() * x.element_size()
    sets = [(x.clone(), dy.clone(), b.clone())
            for _ in range(rotations(nbytes))]
    ms, host_us = time_ms(run, sets)
    plain_ms, _ = time_ms(plain, sets)
    lib_ms = None
    if not relu:
        # the library yardstick: autograd's backward of
        # F.local_response_norm on a retained graph (the same dx)
        graphs = []
        for xs, dys, _ in sets:
            xg = xs.detach().requires_grad_(True)
            graphs.append((F.local_response_norm(xg, ls, alpha, beta, k),
                           xg, dys))
        lib = lambda y, xg, dys: torch.autograd.grad(  # noqa: E731
            y, xg, dys, retain_graph=True)
        lib_ms, _ = time_ms(lib, graphs)
        del graphs
    ops = x.numel() * lrn_bwd_ops_per_elem(ls, relu, False)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    plan = K._lrn_launch_plan(x, ls, 2, int(relu))
    rec.update(ms=ms, host_us=host_us, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               plan=plan._asdict())
    rec["share_of_bound"] = rec["bound_ms"] / ms
    results.setdefault(name, []).append(rec)
    log(f"  {name} {tuple(shape)} {rec['dtype']} relu={relu}: "
        f"max_abs_err {max_err:.3g} (rtol {rtol:.3g} atol {atol:.3g}, "
        f"bit-equal {exact}) kernel {ms:.4f} ms (launch path "
        f"{host_us:.1f} us on the host) plain {plain_ms:.4f} ms library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}): "
        f"{rec['share_of_bound']:.3f} of the bound; tile {plan.tile}, run "
        f"{plan.run} ({plan.runs} runs, {plan.waves:.2f} waves)")


def lrn_view(torch, t, off):
    """t's values in a view `off` elements into a fresh allocation (which
    starts on 16 bytes): a start anywhere in a 16-byte word, as a Slice
    top or a Concat's gradient can have."""
    s = torch.zeros(t.numel() + off, device=t.device, dtype=t.dtype)
    s[off:] = t.reshape(-1)
    return s[off:].view(t.shape)


def check_lrn_starts(K, torch, shape, dtype, results, ls=5):
    """K1 (with and without its ReLU), K3 and K2 (with and without) on x
    and dy that start at each element of a 16-byte word (0-3 in f32, 0-7
    in bf16; dy one element further), each against its plain version on
    the same views: K1 and K3 bit for bit, K2 bit for bit in f32 and
    within one bf16 ulp in bf16 (K4's refusal of such a start is K4's
    alone)."""
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"starts{shape}{dtype}{ls}".encode()))
    x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=g)
    alpha, beta, k = 1e-4, 0.75, 1.0
    per16 = 16 // x.element_size()
    worst = {}
    for off in range(per16):
        xv = lrn_view(torch, x, off)
        dyv = lrn_view(torch, dy, (off + 1) % per16)
        cases = [("bias_relu_lrn_across_channels",
                  K.bias_relu_lrn_across_channels(xv, b, ls, alpha, beta, k),
                  K.lrn_plain(xv, ls, alpha, beta, k, bias=b), True)]
        for relu in (False, True):
            cases += [
                ("lrn_across_channels",
                 K.lrn_across_channels(xv, ls, alpha, beta, k, relu),
                 K.lrn_plain(xv, ls, alpha, beta, k, relu), True),
                ("lrn_across_channels_bwd",
                 K.lrn_across_channels_bwd(xv, dyv, ls, alpha, beta, k,
                                           relu),
                 K.lrn_bwd_plain(xv, dyv, ls, alpha, beta, k, relu),
                 dtype == torch.float32)]
        torch.cuda.synchronize()
        for name, got, want, exact in cases:
            err = (got.float() - want.float()).abs()
            worst[name] = max(worst.get(name, 0.0), float(err.max()))
            if exact:
                check(bool(torch.equal(got, want)),
                      f"{name} {shape} {dtype} local_size {ls}, x {off} "
                      "elements off 16 bytes: not bit-equal to the plain "
                      "version")
            else:
                bad = err > BF16_ATOL + BF16_RTOL * want.float().abs()
                check(not bool(bad.any()),
                      f"{name} {shape} {dtype} local_size {ls}, x {off} "
                      f"elements off 16 bytes: {int(bad.sum())} elements "
                      "outside one bf16 ulp")
    dt = str(dtype).replace("torch.", "")
    for name, err in worst.items():
        results.setdefault(name, []).append(dict(
            shape=list(shape), dtype=dt, local_size=ls, max_abs_err=err,
            starts=list(range(per16)),
            bit_equal=name != "lrn_across_channels_bwd"
            or dtype == torch.float32))
    log(f"  K1, K3, K2 {tuple(shape)} {dt} local_size {ls} at x starts "
        f"0-{per16 - 1} elements off 16 bytes (dy one further): against "
        "the plain versions, K1 and K3 bit-equal, K2 "
        + ("bit-equal" if dtype == torch.float32 else "within one bf16 ulp")
        + " (max abs err " + ", ".join(f"{n} {e:.3g}" for n, e in
                                      worst.items()) + ")")


def check_lrn_graph(K, torch, shape, dtype):
    """K1, K3 and K2 called twice, and captured in a CUDA graph (as
    COS_STEPS_PER_LOOP captures the solver's steps, one launch each
    counted): both calls and the replay byte-equal."""
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"lrn graph {shape}{dtype}".encode()))
    x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=gen)

    def calls():
        return (K.lrn_across_channels(x), K.bias_relu_lrn_across_channels(x, b),
                K.lrn_across_channels_bwd(x, dy))

    eager, again = calls(), calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with K.captured_launches() as rec:
        with torch.cuda.graph(graph):
            captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    check(rec["counts"] == {"lrn_across_channels": 1,
                            "bias_relu_lrn_across_channels": 1,
                            "lrn_across_channels_bwd": 1},
          f"K1 / K3 / K2 capture counted {rec['counts']}")
    check(all(torch.equal(u, v) for u, v in zip(eager, again)),
          f"K1 / K3 / K2 {shape} {dtype}: two calls differ")
    check(all(torch.equal(u, v) for u, v in zip(captured, eager)),
          f"K1 / K3 / K2 {shape} {dtype}: the graph's replay differs from "
          "the eager calls")
    log(f"  K1, K3, K2 {tuple(shape)} {str(dtype).replace('torch.', '')}: "
        "two calls and a CUDA graph's replay byte-equal")


# conv -> ReLU -> LRN (K3 and K4 under COS_FUSE_BIAS_RELU_LRN=1), whose
# top joins a channel Concat second, at a batch of 1: Concat's backward
# hands K4's Function a contiguous narrow of the joined gradient 588
# bytes in, 12 past a 16-byte boundary (the same net as
# tests/torch_common.py's)
FUSED_LRN_CONCAT_NET = """
name: "fused_lrn_concat"
layer { name: "data" type: "Input" top: "data" top: "side" top: "target"
  input_param { shape { dim: 1 dim: 3 dim: 9 dim: 9 }
                shape { dim: 1 dim: 3 dim: 7 dim: 7 }
                shape { dim: 1 dim: 10 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.05 beta: 0.75 } }
layer { name: "cat" type: "Concat" bottom: "side" bottom: "norm1"
  top: "cat" }
layer { name: "ip" type: "InnerProduct" bottom: "cat" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip" bottom: "target"
  top: "loss" }
"""


def check_fused_concat(K, torch) -> dict:
    """The fused LRN behind a non-first Concat at a batch of 1 trains on
    the card: one step launches K3 and K4 once each, K4 given an aligned
    copy of its gradient, and its loss and every gradient match the same
    step with every kernel plain (STEP_LOSS_RTOL; STEP_GRAD_TOL of each
    gradient's max)."""
    import numpy as np
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetParameter
    handed = []
    wrapper = K.bias_relu_lrn_across_channels_bwd

    def seen(x, bias, dy, *args):
        handed.append(dy.data_ptr() % 16)
        return wrapper(x, bias, dy, *args)

    def step():
        net = Net(NetParameter.from_text(FUSED_LRN_CONCAT_NET),
                  device="cuda")
        check(net.fused_bias_lrn == {"norm1": "conv1"},
              f"the concat net fused {net.fused_bias_lrn}")
        params = net.init(seed=1)
        rng = np.random.RandomState(0)
        inputs = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
                  .cuda() for k, s in (("data", (1, 3, 9, 9)),
                                       ("side", (1, 3, 7, 7)),
                                       ("target", (1, 10)))}
        leaves = {ln: {bn: t.clone().requires_grad_(True)
                       for bn, t in bl.items()} for ln, bl in params.items()}
        loss, _ = net.loss(leaves, inputs)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {
            f"{ln}/{bn}": t.grad for ln, bl in leaves.items()
            for bn, t in bl.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with env_set({"COS_FUSE_BIAS_RELU_LRN": "1"}):
            K.reset_launch_counts()
            K.bias_relu_lrn_across_channels_bwd = seen
            try:
                loss, grads = step()
            finally:
                K.bias_relu_lrn_across_channels_bwd = wrapper
            launches = dict(K.launch_counts)
            with plain_kernels(K):
                want_loss, want = step()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(launches["bias_relu_lrn_across_channels"] == 1
          and launches["bias_relu_lrn_across_channels_bwd"] == 1,
          f"the concat net's step launched {launches}")
    check(handed == [0], f"K4 was handed gradients {handed} bytes off 16")
    check(abs(loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss),
          f"the concat net's loss {loss} against the plain step's "
          f"{want_loss}")
    errs = {k: float((grads[k] - g).abs().max() / max(
        float(g.abs().max()), 1e-30)) for k, g in want.items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= STEP_GRAD_TOL,
          f"the concat net's {worst} gradient {errs[worst]:.3g} of its max "
          "from the plain step's")
    log(f"  fused LRN behind a Concat at batch 1: K3 / K4 launched once "
        f"each, K4 handed an aligned gradient; loss {loss:.6g} against "
        f"{want_loss:.6g}, gradients within {errs[worst]:.3g} of their max "
        f"({worst})")
    return dict(loss=loss, plain_loss=want_loss, grad_err_of_max=errs)


def k4_db_allowance(K, shape, mass):
    """The rounding allowance of K4's d_bias against an exact sum: 2^-24
    times the additions on the longest path of its sum (log2 of a tile's
    positions, then the partials one thread of `sum_partials` adds in
    turn, then its 256-wide tree) times the channel's sum of |dx|: the
    bound of any summation of that depth."""
    parts = shape[0] * -(-shape[2] * shape[3] // K.K4_TILE)
    depth = math.ceil(math.log2(K.K4_TILE)) + -(-parts // 256) + 8
    return 2.0 ** -24 * depth * mass


def check_k4(K, torch, shape, dtype, results, timed=True, ls=5):
    """K4 against its plain version on the same x, dy and bias: dx to
    rtol / atol, d_bias to rtol / atol plus the rounding of its sum
    (`k4_db_allowance`) against the exact sum of the dx it returns and,
    with the dx differences added, against the plain version's d_bias;
    a second call byte-equal.  Timed: the fused call, its share of the
    byte bound, and the fused backward through BiasReluLRNAcrossChannels
    against K4's dx-only build (the same kernel without d_bias's sums,
    its dx checked equal) followed by a separate
    dx.float().sum((0, 2, 3)), the d_bias pass the fusion replaces."""
    name = "bias_relu_lrn_across_channels_bwd"
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"{name}{shape}{dtype}False{ls}".encode()))
    x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=g)
    alpha, beta, k = 1e-4, 0.75, 1.0
    run = lambda x, dy, b: K.bias_relu_lrn_across_channels_bwd(  # noqa: E731
        x, b, dy, ls, alpha, beta, k)
    plain = lambda x, dy, b: K.bias_relu_lrn_bwd_plain(  # noqa: E731
        x, b, dy, ls, alpha, beta, k)
    got, got_db = run(x, dy, b)
    again, again_db = run(x, dy, b)
    torch.cuda.synchronize()
    want, want_db = plain(x, dy, b)
    err = (got.float() - want.float()).abs()
    rtol, atol = ((BWD_RTOL, BWD_ATOL) if dtype == torch.float32
                  else (BF16_RTOL, BF16_ATOL))
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    check(not bool(bad.any()),
          f"{name} {shape} {dtype} local_size {ls}: dx: {int(bad.sum())} "
          f"elements outside rtol {rtol} atol {atol} (max abs err "
          f"{max_err:.3g})")
    check(torch.equal(got, again) and torch.equal(got_db, again_db),
          f"{name} {shape} {dtype}: two calls differ")
    dims = (0, 2, 3)
    mass = got.double().abs().sum(dims)
    allow = k4_db_allowance(K, shape, mass)
    own = got.double().sum(dims)
    e_own = (got_db.double() - own).abs()
    lim_own = atol + rtol * own.abs() + allow
    e_plain = (got_db.double() - want_db.double()).abs()
    lim_plain = (atol + rtol * want_db.double().abs() + 2 * allow
                 + (got.double() - want.double()).abs().sum(dims))
    check(bool((e_own <= lim_own).all()),
          f"{name} {shape} {dtype}: d_bias is not the sum of its dx "
          f"(max err {float(e_own.max()):.3g}, "
          f"{float((e_own / lim_own).max()):.3g} of the limit)")
    check(bool((e_plain <= lim_plain).all()),
          f"{name} {shape} {dtype}: d_bias against the plain version's "
          f"(max err {float(e_plain.max()):.3g}, "
          f"{float((e_plain / lim_plain).max()):.3g} of the limit)")
    rec = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
               relu=False, local_size=ls, max_abs_err=max_err,
               bit_equal=bool(torch.equal(got, want)),
               db_max_abs_err=float(e_own.max()),
               db_of_limit=float((e_own / lim_own).max()),
               db_vs_plain_max_abs_err=float(e_plain.max()),
               db_vs_plain_of_limit=float((e_plain / lim_plain).max()),
               db_bit_equal=bool(torch.equal(got_db, want_db)),
               repeat_byte_equal=True)
    head = (f"  {name} {tuple(shape)} {rec['dtype']} local_size {ls}: dx "
            f"max_abs_err {max_err:.3g} (rtol {rtol:.3g} atol {atol:.3g}, "
            f"bit-equal {rec['bit_equal']}); db max err "
            f"{rec['db_max_abs_err']:.3g} against its dx's exact sum "
            f"({rec['db_of_limit']:.3g} of the limit), "
            f"{rec['db_vs_plain_max_abs_err']:.3g} against the plain "
            f"version's ({rec['db_vs_plain_of_limit']:.3g}); repeat "
            "byte-equal")
    if not timed:
        log(head)
        results.setdefault(name, []).append(rec)
        return
    nbytes = 3 * x.numel() * x.element_size() + 8 * shape[1]
    sets = [(x.clone(), dy.clone(), b.clone())
            for _ in range(rotations(nbytes))]
    ms, host_us = time_ms(run, sets)
    plain_ms, _ = time_ms(plain, sets)
    # the fused backward through the Function (dx and db from K4), and
    # the dx-only build of K4 (its C entry point without the partial-sum
    # buffer, on its own launch plan) followed by the separate f32 sum
    # the fusion replaces
    lib = K.cuda_build.library("lrn")
    code = K._LRN_DTYPES[dtype]
    n, c, hw = shape[0], shape[1], shape[2] * shape[3]
    dx_plan = K.k4_plan(tuple(shape), ls, K._sm_count(0),
                        lib.cos_bias_relu_lrn_bwd_occupancy(ls, code, 0))
    stream = torch.cuda.current_stream().cuda_stream

    def dx_only(x, dy, b):
        out = torch.empty_like(x)
        status = lib.cos_bias_relu_lrn_bwd(
            x.data_ptr(), b.data_ptr(), dy.data_ptr(), out.data_ptr(), None,
            None, n, c, hw, ls, alpha / ls, -beta, -beta - 1.0, k,
            2.0 * alpha * beta / ls, dx_plan.tiles, dx_plan.run, code,
            stream)
        check(status == 0, f"{name} dx only: cudaError {status}")
        return out

    check(torch.equal(dx_only(x, dy, b), got),
          f"{name} {shape} {dtype}: the dx-only build's dx differs")
    graphs = []
    for xs, dys, bs in sets:
        xg = xs.detach().requires_grad_(True)
        bg = bs.detach().requires_grad_(True)
        graphs.append((K.BiasReluLRNAcrossChannels.apply(
            xg, bg, ls, alpha, beta, k), xg, bg, dys))
    fused = lambda y, xg, bg, dys: torch.autograd.grad(  # noqa: E731
        y, (xg, bg), dys, retain_graph=True)
    fused_ms, _ = time_ms(fused, graphs)
    del graphs
    dx_only_ms, _ = time_ms(dx_only, sets)
    separate = lambda x, dy, b: dx_only(x, dy, b).float().sum(  # noqa: E731
        dims).to(b.dtype)
    separate_ms, _ = time_ms(separate, sets)
    sum_sets = [(run(*st)[0],) for st in sets]
    sum_ms, _ = time_ms(lambda d: d.float().sum(dims), sum_sets)
    del sum_sets
    ops = x.numel() * (lrn_bwd_ops_per_elem(ls, True, True) + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    bound = 1e3 * max(t_bytes, t_ops)
    rec.update(ms=ms, host_us=host_us, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               share_of_bound=bound / ms, fused_backward_ms=fused_ms,
               dx_only_ms=dx_only_ms, dx_only_then_separate_sum_ms=separate_ms,
               separate_sum_ms=sum_ms)
    results.setdefault(name, []).append(rec)
    log(head)
    log(f"    kernel {ms:.4f} ms (launch path {host_us:.1f} us on the "
        f"host) plain {plain_ms:.4f} ms bound {bound:.4f} ms "
        f"({rec['bound_by']}): "
        f"{rec['share_of_bound']:.3f} of the bound; fused backward "
        f"{fused_ms:.4f} ms against K4's dx-only build then the separate "
        f"sum {separate_ms:.4f} ms (dx only {dx_only_ms:.4f} ms, the sum "
        f"alone {sum_ms:.4f} ms)")
    check(fused_ms < separate_ms,
          f"{name} {shape} {dtype}: the fused backward ({fused_ms:.4f} "
          f"ms) is not faster than K4's dx only then the separate sum "
          f"({separate_ms:.4f})")


def check_k4_graph(K, torch, shape, dtype):
    """K4 captured in a CUDA graph (as COS_STEPS_PER_LOOP captures the
    solver's steps): the replay's dx and d_bias byte-equal to the eager
    call's."""
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"k4 graph {shape}{dtype}".encode()))
    x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    b = torch.randn(shape[1], device="cuda", generator=gen)
    eager = K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with K.captured_launches():
        with torch.cuda.graph(graph):
            out = K.bias_relu_lrn_across_channels_bwd(x, b, dy)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1]),
          f"K4 {shape} {dtype}: the graph's replay differs from the eager "
          "call")
    log(f"  bias_relu_lrn_across_channels_bwd {tuple(shape)} "
        f"{str(dtype).replace('torch.', '')}: a CUDA graph's replay "
        "byte-equal to the eager call (dx and d_bias)")


def check_int8(K, torch, m, n, kk, results, timed=True):
    g = torch.Generator(device="cuda").manual_seed(m * 131 + n * 7 + kk)
    xq = torch.randint(-127, 128, (m, kk), device="cuda", generator=g,
                       dtype=torch.int64).to(torch.int8)
    wq = torch.randint(-127, 128, (n, kk), device="cuda", generator=g,
                       dtype=torch.int64).to(torch.int8)
    got = K.int8_matmul(xq, wq)
    torch.cuda.synchronize()
    want = K.int8_matmul_plain(xq, wq)
    max_err = int((got.long() - want.long()).abs().max())
    check(got.dtype == torch.int32 and max_err == 0,
          f"int8_matmul ({m},{kk})x({n},{kk}): not exact "
          f"(max abs err {max_err})")
    # a second call on the same inputs gives the same exact product
    check(torch.equal(K.int8_matmul(xq, wq), want),
          f"int8_matmul ({m},{kk})x({n},{kk}): a second call differs")
    rec = dict(shape=[m, n, kk], dtype="int8", max_abs_err=max_err)
    if timed:
        nbytes = m * kk + n * kk + 4 * m * n
        sets = [(xq.clone(), wq.clone()) for _ in range(rotations(nbytes))]
        ms, host_us = time_ms(K.int8_matmul, sets)
        plain_ms, _ = time_ms(K.int8_matmul_plain, sets, iters=5)
        try:
            lib_ms, _ = time_ms(lambda a, w: torch._int_mm(a, w.t()),
                                sets)
        except RuntimeError as e:
            log(f"  torch._int_mm refused ({m},{kk})x({n},{kk}): {e}")
            lib_ms = None
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2.0 * m * n * kk / INT8_OPS_PER_S
        rec.update(ms=ms, host_us=host_us, plain_ms=plain_ms,
                   library_ms=lib_ms,
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        check(torch.equal(K.int8_matmul(xq, wq), want),
              f"int8_matmul ({m},{kk})x({n},{kk}): not exact after "
              "the timed calls")
        log(f"  int8_matmul M={m} N={n} K={kk}: exact; kernel {ms:.4f} ms "
            f"(launch path {host_us:.1f} us on the host) "
            f"plain {plain_ms:.4f} ms library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    else:
        log(f"  int8_matmul M={m} N={n} K={kk}: exact")
    results.setdefault("int8_matmul", []).append(rec)


def flash_pairs(t: int, causal: bool) -> int:
    """(query, key) pairs a head's attention scores: the causal pass
    skips the hidden half, so count what these inputs need."""
    return t * (t + 1) // 2 if causal else t * t


def _flash_err(name, got, want, dtype, torch, fwd):
    """max abs error, bit-equality and the tolerance check of one
    output against its plain version."""
    rtol = atol = FLASH_FWD_TOL
    if not fwd:
        rtol, atol = FLASH_GRAD_RTOL, FLASH_GRAD_ATOL
    if dtype == torch.bfloat16:
        rtol += BF16_RTOL
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    max_err = float(err.max())
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} elements outside "
          f"rtol {rtol:.3g} atol {atol:.3g} (max abs err {max_err:.3g}, "
          f"max |plain| {float(w.abs().max()):.3g})")
    return max_err, bool(torch.equal(got, want)), int((g != w).sum())


def mma_bound(ops, dtype):
    """K6/K7/K8's bound on their route: f32 inputs as 3xTF32 (three tf32
    products per product) at TF32_OPS_PER_S, bf16 at BF16_OPS_PER_S;
    and the f32 SIMT figure (F32_OPS_PER_S) earlier rows were held to."""
    import torch
    if dtype == torch.float32:
        return 3 * ops / TF32_OPS_PER_S, "3xTF32 tensor cores", \
            ops / F32_OPS_PER_S
    return ops / BF16_OPS_PER_S, "bf16 tensor cores", ops / F32_OPS_PER_S


def _flash_ref64(q, k, v, do, lse, delta, causal):
    """O, dq, dk, dv in float64 from the same inputs and statistics
    (the plain versions' formulas)."""
    import torch
    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        t = s.shape[-1]
        keep = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, -1e30)
    o = torch.softmax(s, -1) @ v
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta.double()[..., None]) \
        / math.sqrt(q.shape[-1])
    return o, ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def check_flash(K, torch, shape, dtype, causal, results, timed=True,
                out_dtype=None):
    """K6, K7 and K8 against their plain versions on the same q, k, v,
    dO (B*H, T, D) and, timed, against F.scaled_dot_product_attention
    and its autograd backward on the same inputs as (B, H, T, D).  K7
    and K8 run twice on the same inputs and must give bit-equal
    gradients.  `out_dtype` is the gradients' dtype (the sp ring's
    backward asks for float32 from bf16 inputs)."""
    import torch.nn.functional as F
    bh, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"flash{shape}{dtype}{causal}".encode()))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    before = dict(K.launch_counts)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = K.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    fwd_det = torch.equal(o, o2) and torch.equal(lse, lse2)
    check(fwd_det, f"flash_attention_fwd {shape} {dtype} causal={causal}: "
          "two runs on the same inputs differ")
    del o2, lse2
    o_p, lse_p = K.flash_attention_plain(q, k, v, causal)
    gdt = out_dtype or dtype
    tag = (f"{shape} {str(dtype).replace('torch.', '')} causal={causal}"
           + (f" out {str(gdt).replace('torch.', '')}" if out_dtype else ""))
    e_o = _flash_err(f"flash_attention_fwd {tag} O", o, o_p, dtype, torch,
                     True)
    e_l = _flash_err(f"flash_attention_fwd {tag} lse", lse, lse_p,
                     torch.float32, torch, True)
    # the backward from the plain forward's statistics, as autograd does
    delta = torch.sum(do.float() * o_p.float(), dim=-1)
    bwd = lambda: (  # noqa: E731
        K.flash_attention_bwd_dq(q, k, v, do, lse_p, delta, causal,
                                 out_dtype),
        *K.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, causal,
                                   out_dtype))
    dq, dk, dv = bwd()
    again = bwd()
    torch.cuda.synchronize()
    # every call launched its kernel (at D > 256 the wide ones): no call
    # went to a plain version
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(K.launch_counts[name] - before[name] == 2,
              f"{name} {shape}: {K.launch_counts[name] - before[name]} "
              "launches for 2 calls")
    deterministic = all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                          again))
    check(deterministic, f"flash backward {tag}: two runs on the same "
          "inputs differ")
    del again
    dq_p, dk_p, dv_p = K.flash_bwd_block_plain(q, k, v, do, lse_p, delta,
                                               causal=causal,
                                               out_dtype=out_dtype)
    e_dq = _flash_err(f"flash_attention_bwd_dq {tag}", dq, dq_p, gdt,
                      torch, False)
    e_dk = _flash_err(f"flash_attention_bwd_dkv {tag} dk", dk, dk_p, gdt,
                      torch, False)
    e_dv = _flash_err(f"flash_attention_bwd_dkv {tag} dv", dv, dv_p, gdt,
                      torch, False)
    base = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                causal=causal)
    bwd_base = dict(base, out_dtype=str(gdt).replace("torch.", ""),
                    deterministic=deterministic)
    recs = {
        "flash_attention_fwd": dict(base, max_abs_err=max(e_o[0], e_l[0]),
                                    bit_equal=e_o[1] and e_l[1],
                                    elements_differing=e_o[2] + e_l[2],
                                    deterministic=fwd_det),
        "flash_attention_bwd_dq": dict(bwd_base, max_abs_err=e_dq[0],
                                       bit_equal=e_dq[1],
                                       elements_differing=e_dq[2]),
        "flash_attention_bwd_dkv": dict(
            bwd_base, max_abs_err=max(e_dk[0], e_dv[0]),
            bit_equal=e_dk[1] and e_dv[1],
            elements_differing=e_dk[2] + e_dv[2]),
    }
    maxes = (float(o_p.float().abs().max()), float(dq_p.float().abs().max()),
             float(dk_p.float().abs().max()), float(dv_p.float().abs().max()))
    if d > 128:
        # the kernels' and the plain versions' error against float64
        ref = _flash_ref64(q, k, v, do, lse_p, delta, causal)
        errs = {nm: [float((x.double() - r).abs().max()) for x in xs]
                for nm, xs, r in zip(("O", "dq", "dk", "dv"),
                                     ((o, o_p), (dq, dq_p), (dk, dk_p),
                                      (dv, dv_p)), ref)}
        del ref
        for name in recs:
            recs[name]["f64_err_kernel_plain"] = errs
        log("    against float64, kernel / plain: " + ", ".join(
            f"{nm} {e[0]:.3g} / {e[1]:.3g}" for nm, e in errs.items()))
    del o, lse, dq, dk, dv, dq_p, dk_p, dv_p
    if timed:
        heads = 16 if bh % 16 == 0 else bh   # SDPA's (B, H, T, D)
        b4 = bh // heads
        esz = q.element_size()
        gsz = torch.empty((), dtype=gdt).element_size()
        pairs = bh * flash_pairs(t, causal)
        row = 4 * bh * t                 # one (B*H, T) f32 statistic
        io = bh * t * d * esz            # one (B*H, T, D) operand
        gio = bh * t * d * gsz           # one (B*H, T, D) gradient
        sets = [tuple(x.clone() for x in (q, k, v, do, lse_p, delta))
                for _ in range(rotations(6 * io))]
        timing = {
            "flash_attention_fwd": (
                lambda q, k, v, do, lse, dl: K.flash_attention_fwd(
                    q, k, v, causal),
                lambda q, k, v, do, lse, dl: K.flash_attention_plain(
                    q, k, v, causal),
                4 * d * pairs, 4 * io + row),
            "flash_attention_bwd_dq": (
                lambda q, k, v, do, lse, dl: K.flash_attention_bwd_dq(
                    q, k, v, do, lse, dl, causal, out_dtype),
                lambda q, k, v, do, lse, dl: K.flash_bwd_dq_plain(
                    q, k, v, do, lse, dl, causal, out_dtype),
                6 * d * pairs, 4 * io + gio + 2 * row),
            "flash_attention_bwd_dkv": (
                lambda q, k, v, do, lse, dl: K.flash_attention_bwd_dkv(
                    q, k, v, do, lse, dl, causal, out_dtype),
                lambda q, k, v, do, lse, dl: K.flash_bwd_dkv_plain(
                    q, k, v, do, lse, dl, causal, out_dtype),
                8 * d * pairs, 4 * io + 2 * gio + 2 * row),
        }
        # the library yardstick: one SDPA call, and one autograd backward
        # of it (dq, dk, dv together) on a retained graph
        lib_sets = [tuple(x.reshape(b4, heads, t, d) for x in st[:3])
                    for st in sets]
        lib_fwd, _ = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), lib_sets)
        graphs = []
        for st in sets:
            xs = [x.reshape(b4, heads, t, d).detach().requires_grad_(True)
                  for x in st[:3]]
            graphs.append((F.scaled_dot_product_attention(
                *xs, is_causal=causal), xs, st[3].reshape(b4, heads, t, d)))
        lib_bwd, _ = time_ms(lambda y, xs, dy: torch.autograd.grad(
            y, xs, dy, retain_graph=True), graphs)
        del graphs
        for name, (run, plain, ops, nbytes) in timing.items():
            ms, host_us = time_ms(run, sets)
            plain_ms, _ = time_ms(plain, sets, iters=5)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops, route, simt = mma_bound(ops, dtype)
            recs[name].update(
                ms=ms, host_us=host_us, plain_ms=plain_ms,
                library_ms=lib_fwd if name == "flash_attention_fwd"
                else lib_bwd, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=ops / 1e9)
            recs[name].update(bound_route=route,
                              f32_simt_bound_ms=1e3 * max(t_bytes, simt))
        del sets
    for name, rec in recs.items():
        results.setdefault(name, []).append(rec)
        times = ("" if "ms" not in rec else
                 f" kernel {rec['ms']:.4f} ms (launch path "
                 f"{rec['host_us']:.1f} us) plain {rec['plain_ms']:.4f} ms "
                 f"library {rec['library_ms']:.4f} ms bound "
                 f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}"
                 + (f", {rec['bound_route']}; f32 SIMT "
                    f"{rec['f32_simt_bound_ms']:.4f} ms"
                    if "bound_route" in rec else "") + ")")
        det = ("" if "deterministic" not in rec
               else f", deterministic {rec['deterministic']}")
        log(f"  {name} {tag}: max_abs_err {rec['max_abs_err']:.3g} "
            f"(bit-equal {rec['bit_equal']}, "
            f"{rec['elements_differing']} elements differ{det}){times}")
    log(f"    max |plain| O {maxes[0]:.3g} dq {maxes[1]:.3g} "
        f"dk {maxes[2]:.3g} dv {maxes[3]:.3g}")


def carry_pairs(bh, t_q, t_k, q_off, k_off, causal) -> int:
    """(query, key) pairs one K9 hop scores: with `causal`, only those
    with q_off + r >= k_off + c (what these offsets need)."""
    if not causal:
        return bh * t_q * t_k
    return bh * sum(min(t_k, max(0, q_off + r - k_off + 1))
                    for r in range(t_q))


def check_block_update(K, torch, shape, dtype, causal, q_off, k_off, first,
                       results, timed=True):
    """K9 against its plain version on the same q, block (k, v) and carry:
    the ring's first carry (-inf, 0, 0) or a mid-ring one (the carry after
    an earlier hop over the block before k), run twice (bit-equal, two
    launches).  m, l and acc are held to FLASH_FWD_TOL relative and
    FLASH_FWD_TOL of their largest finite element (acc is an unnormalized
    sum of signed terms); a row the plain version leaves at -1e30 must
    not come back -inf.  Timed, the bound is on K9's tensor-core route
    (`mma_bound`)."""
    bh, t_q, t_k, d = shape
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(
        f"carry{shape}{dtype}{causal}{q_off}{k_off}{first}".encode()))
    q = torch.randn((bh, t_q, d), device="cuda", generator=g).to(dtype)
    k, v = (torch.randn((bh, t_k, d), device="cuda", generator=g).to(dtype)
            for _ in range(2))
    if first:
        carry = (torch.full((bh, t_q), -math.inf, device="cuda"),
                 torch.zeros((bh, t_q), device="cuda"),
                 torch.zeros((bh, t_q, d), device="cuda"))
    else:     # an earlier hop's carry: keys 0..t_k of a block before k
        kp, vp = (torch.randn((bh, t_k, d), device="cuda", generator=g)
                  .to(dtype) for _ in range(2))
        carry = K.flash_block_update_plain(
            q, kp, vp, torch.full((bh, t_q), -math.inf, device="cuda"),
            torch.zeros((bh, t_q), device="cuda"),
            torch.zeros((bh, t_q, d), device="cuda"), q_off,
            k_off - t_k, causal)
    before = K.launch_counts["flash_block_update"]
    got = K.flash_block_update(q, k, v, *carry, q_off, k_off, causal)
    again = K.flash_block_update(q, k, v, *carry, q_off, k_off, causal)
    torch.cuda.synchronize()
    check(K.launch_counts["flash_block_update"] - before == 2,
          f"flash_block_update {shape}: 2 calls did not launch twice")
    deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    want = K.flash_block_update_plain(q, k, v, *carry, q_off, k_off, causal)
    tag = (f"({bh}, {t_q}, {t_k}, {d}) {str(dtype).replace('torch.', '')} "
           f"causal={causal} q_off={q_off} k_off={k_off} "
           f"carry={'first' if first else 'mid-ring'}")
    max_err, unseen = 0.0, int((want[0] <= FLASH_NEG_HALF).sum())
    for part, gx, wx in zip(("m", "l", "acc"), got, want):
        real = wx[wx > FLASH_NEG_HALF]
        scale = float(real.abs().max()) if real.numel() else 0.0
        err = (gx - wx).abs()
        bad = err > FLASH_FWD_TOL * (wx.abs() + scale)
        check(not bool(bad.any()), f"flash_block_update {tag} {part}: "
              f"{int(bad.sum())} elements outside rtol {FLASH_FWD_TOL} "
              f"(max abs err {float(err.max()):.3g}, scale {scale:.3g})")
        if part != "m":
            max_err = max(max_err, float(err.max()))
    check(torch.equal(got[0] <= FLASH_NEG_HALF, want[0] <= FLASH_NEG_HALF),
          f"flash_block_update {tag}: rows that saw no key differ")
    check(deterministic, f"flash_block_update {tag}: two runs on the same "
          "inputs differ")
    rec = dict(shape=[bh, t_q, t_k, d],
               dtype=str(dtype).replace("torch.", ""), causal=causal,
               q_off=q_off, k_off=k_off, carry="first" if first else "mid",
               max_abs_err=max_err, rows_unseen=unseen,
               deterministic=deterministic)
    if timed:
        esz = q.element_size()
        pairs = carry_pairs(bh, t_q, t_k, q_off, k_off, causal)
        # q, k, v read; m, l, acc read and written (f32)
        nbytes = (t_q + 2 * t_k) * bh * d * esz + 2 * 4 * bh * t_q * (d + 2)
        sets = [tuple(x.clone() for x in (q, k, v) + tuple(carry))
                for _ in range(rotations(nbytes))]
        run = lambda *a: K.flash_block_update(  # noqa: E731
            *a, q_off, k_off, causal)
        plain = lambda *a: K.flash_block_update_plain(  # noqa: E731
            *a, q_off, k_off, causal)
        ms, host_us = time_ms(run, sets)
        plain_ms, _ = time_ms(plain, sets, iters=5)
        del sets
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops, route, simt = mma_bound(4 * d * pairs, dtype)
        rec.update(ms=ms, host_us=host_us, plain_ms=plain_ms,
                   library_ms=None, bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   gflop=4 * d * pairs / 1e9, bound_route=route,
                   f32_simt_bound_ms=1e3 * max(t_bytes, simt))
    results.setdefault("flash_block_update", []).append(rec)
    times = ("" if "ms" not in rec else
             f" kernel {rec['ms']:.4f} ms (launch path {rec['host_us']:.1f}"
             f" us) plain {rec['plain_ms']:.4f} ms bound "
             f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
             f"{rec['bound_route']}; f32 SIMT "
             f"{rec['f32_simt_bound_ms']:.4f} ms)")
    log(f"  flash_block_update {tag}: max_abs_err (l, acc) {max_err:.3g}, "
        f"{unseen} rows saw no key, deterministic {deterministic}{times}")


def kernel_phase(K, torch) -> dict:
    res: dict = {}
    lrn_cases = [  # (name, shape, relu, bias); the first of each is main
        ("lrn_across_channels", (B, 96, 27, 27), False, False),
        ("lrn_across_channels", (B, 256, 13, 13), False, False),
        ("lrn_across_channels", (B, 96, 55, 55), True, False),
        ("lrn_across_channels", (B, 256, 27, 27), True, False),
        ("bias_relu_lrn_across_channels", (B, 96, 55, 55), False, True),
        ("bias_relu_lrn_across_channels", (B, 256, 27, 27), False, True),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, relu, bias in lrn_cases:
            check_lrn(K, torch, name, shape, dtype, relu, bias, res)
    # the training path's forward shapes (f32; after the serving rows,
    # so each kernel's first record stays its B=64 serving shape)
    for name, shape, relu, bias in lrn_cases:
        if relu:
            continue
        check_lrn(K, torch, name, (TRAIN_B,) + shape[1:], torch.float32,
                  relu, bias, res)
    bwd_cases = [  # K2 at the training path's shapes; the first is main
        ((TRAIN_B, 96, 27, 27), False), ((TRAIN_B, 256, 13, 13), False),
        ((TRAIN_B, 96, 55, 55), True)]
    k4_cases = [  # K4: AlexNet's norm1 / norm2 at B=256 (the first is
        # main) and GoogLeNet's fused norm2 (phase 23's shape)
        (TRAIN_B, 96, 55, 55), (TRAIN_B, 256, 27, 27), (ZOO_B, 192, 56, 56)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, relu in bwd_cases:
            check_lrn_bwd(K, torch, "lrn_across_channels_bwd", shape, dtype,
                          relu, res)
        for shape in k4_cases:
            check_k4(K, torch, shape, dtype, res)
        for relu in (False, True):
            check_lrn_bwd(K, torch, "lrn_across_channels_bwd",
                          (3, 13, 7, 9), dtype, relu, res, timed=False)
        check_k4(K, torch, (3, 13, 7, 9), dtype, res, timed=False)
        check_k4_graph(K, torch, (16, 96, 55, 55), dtype)
    # windows wider than the register ring's (the runtime-window
    # variant), and a batch past grid.y's 65,535 at a small C*H*W
    for dtype in (torch.float32, torch.bfloat16):
        for shape, ls in (((8, 96, 27, 27), 13), ((3, 13, 7, 9), 13),
                          ((65_600, 4, 3, 3), 5), ((65_600, 4, 3, 3), 13)):
            for name, relu, bias in (("lrn_across_channels", False, False),
                                     ("lrn_across_channels", True, False),
                                     ("bias_relu_lrn_across_channels",
                                      False, True)):
                check_lrn(K, torch, name, shape, dtype, relu, bias, res,
                          ls=ls, timed=False)
            for relu in (False, True):
                check_lrn_bwd(K, torch, "lrn_across_channels_bwd", shape,
                              dtype, relu, res, timed=False, ls=ls)
            check_k4(K, torch, shape, dtype, res, timed=False, ls=ls)
    # the dp ranks' shapes (phase 32): CaffeNet's B=256 over dp 2 (dp 4's
    # B=64 is the serving shape above), AlexNet's fused stem over dp 2
    for b in (TRAIN_B // 2, TRAIN_B // 4):
        for name, shape in (("lrn_across_channels", (b, 96, 27, 27)),
                            ("lrn_across_channels", (b, 256, 13, 13))):
            check_lrn(K, torch, name, shape, torch.float32, False, False,
                      res, timed=False)
            check_lrn_bwd(K, torch, name + "_bwd", shape, torch.float32,
                          False, res, timed=False)
    for shape in ((TRAIN_B // 2, 96, 55, 55), (TRAIN_B // 2, 256, 27, 27)):
        check_lrn(K, torch, "bias_relu_lrn_across_channels", shape,
                  torch.float32, False, True, res, timed=False)
        check_k4(K, torch, shape, torch.float32, res, timed=False)
    # K1-K3 on views that start anywhere (13x13 on two tiles of 96, 27x27
    # on tiles of 128, the runtime-window kernels), their repeats and
    # CUDA graph replays; the fused LRN behind a Concat at batch 1
    for dtype in (torch.float32, torch.bfloat16):
        for shape, ls in (((8, 256, 13, 13), 5), ((8, 96, 27, 27), 5),
                          ((8, 256, 13, 13), 13)):
            check_lrn_starts(K, torch, shape, dtype, res, ls)
        for shape in ((16, 256, 13, 13), (16, 96, 27, 27)):
            check_lrn_graph(K, torch, shape, dtype)
    res["fused_concat_batch_1"] = check_fused_concat(K, torch)
    for m, n, kk in ((B, 4096, 9216), (B, 4096, 4096), (B, 1000, 4096)):
        check_int8(K, torch, m, n, kk, res)
    for m, n, kk in ((1, 4096, 9216), (2, 1000, 4096), (4, 4096, 4096),
                     (5, 70, 1001), (3, 37, 16)):
        check_int8(K, torch, m, n, kk, res, timed=False)
    flash_phase(K, torch, res)
    return res


def flash_phase(K, torch, res):
    """K6-K8 at the LM's (B*H, T, D), causal first (the main path's),
    f32 then bf16, then ragged shapes untimed."""
    # the plain versions' f32 products in full f32, as the solver pins
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            check_flash(K, torch, (FLASH_BH, FLASH_T, FLASH_D), dtype,
                        causal, res)
    # the widest head the kernels take, and the sp ring's backward call:
    # one rank's 512-row blocks, bf16 in, f32 gradients out
    check_flash(K, torch, (FLASH_BH, FLASH_T, 128), torch.float32, True, res)
    for causal in (True, False):
        check_flash(K, torch, (FLASH_BH, SP_T_LOCAL, FLASH_D),
                    torch.bfloat16, causal, res, out_dtype=torch.float32)
    # head_dim 256, the widest the kernels take (the LM at 4 heads)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            check_flash(K, torch, (FLASH_BH // 4, FLASH_T, 256), dtype,
                        causal, res)
    # head_dim 512, the wide kernels (the LM at 2 heads)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            check_flash(K, torch, (FLASH_BH // 8, FLASH_T, 512), dtype,
                        causal, res)
    # the LM's (B/dp * H/tp, T, D) block at dp 2 x tp 2 (phase 32), bf16
    # under -dtype mixed
    check_flash(K, torch, (FLASH_BH // 4, FLASH_T, FLASH_D), torch.bfloat16,
                True, res, timed=False)
    for shape in ((3, 200, 48), (4, 384, 32), (4, 384, 200), (3, 200, 257),
                  (2, 130, 320), (2, 96, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_flash(K, torch, shape, dtype, causal, res,
                            timed=False)
    # K9 at the ring's per-rank shape (T 2048 over sp 4): the diagonal
    # causal hop first (the main record), a fully visible causal hop, a
    # non-causal one; first-hop and mid-ring carries; then a ragged hop
    # whose causal edge leaves rows with no visible key
    t = SP_T_LOCAL
    for dtype in (torch.float32, torch.bfloat16):
        for causal, q_off, k_off in ((True, t, t), (True, 3 * t, 0),
                                     (False, t, 0)):
            for first in (True, False):
                check_block_update(K, torch, (FLASH_BH, t, t, FLASH_D),
                                   dtype, causal, q_off, k_off, first, res,
                                   timed=first)
        for causal in (True, False):
            check_block_update(K, torch, (3, 200, 328, 48), dtype, causal,
                               100, 150, True, res, timed=False)
        # a dp row's ring at dp 2 x sp 2 (phase 32): (B/2 * H, T/2, T/2, D)
        th = FLASH_T // 2
        check_block_update(K, torch, (FLASH_BH // 2, th, th, FLASH_D),
                           dtype, True, th, th, True, res, timed=False)
        # head_dim 256: a diagonal and a full causal hop; a ragged D
        for q_off, k_off in ((t, t), (3 * t, 0)):
            check_block_update(K, torch, (FLASH_BH // 4, t, t, 256), dtype,
                               True, q_off, k_off, True, res)
        check_block_update(K, torch, (3, 200, 328, 200), dtype, True, 100,
                           150, False, res, timed=False)
        # head_dim 512 (the wide kernel): a diagonal and a full causal hop;
        # ragged wide hops whose first rows see no key
        for q_off, k_off in ((t, t), (3 * t, 0)):
            check_block_update(K, torch, (FLASH_BH // 8, t, t, 512), dtype,
                               True, q_off, k_off, True, res)
        for d in (257, 320, 1024):
            for first in (True, False):
                check_block_update(K, torch, (2, 200, 136, d), dtype, True,
                                   100, 150, first, res, timed=False)
        check_block_update(K, torch, (2, 100, 37, 320), dtype, False, 10,
                           60, False, res, timed=False)


# ---------------------------------------------------------------------------
# phases 4-6: serve full-width nets through the CLI path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels(K, names=None):
    """Swap every kernel wrapper (or those in `names`) for its plain
    PyTorch version (the reference forward of phases 5/6 and the
    reference steps of phases 10 and 13 only; restored on exit).  The
    autograd Functions look the wrappers up in the module, so they
    follow the swap."""
    plain = {
        "lrn_across_channels": (
            lambda x, ls=5, a=1e-4, b=0.75, k=1.0, fuse_relu=False:
            K.lrn_plain(x, ls, a, b, k, fuse_relu)),
        "lrn_across_channels_bwd": K.lrn_bwd_plain,
        "bias_relu_lrn_across_channels": (
            lambda x, bias, ls=5, a=1e-4, b=0.75, k=1.0:
            K.lrn_plain(x, ls, a, b, k, bias=bias)),
        "bias_relu_lrn_across_channels_bwd": K.bias_relu_lrn_bwd_plain,
        "int8_matmul": K.int8_matmul_plain,
        "flash_attention_fwd": K.flash_attention_plain,
        "flash_attention_bwd_dq": K.flash_bwd_dq_plain,
        "flash_attention_bwd_dkv": K.flash_bwd_dkv_plain,
        "flash_block_update": K.flash_block_update_plain,
    }
    names = tuple(plain) if names is None else names
    saved = {n: getattr(K, n) for n in names}
    for n in names:
        setattr(K, n, plain[n])
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


@contextlib.contextmanager
def env_set(env):
    """The knobs a configuration sets, for the construction of one
    service (the net and the registry read them once, there)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_model(workdir: str, zoo_fn, seed: int):
    """solver + net prototxt and a seeded full-width .caffemodel."""
    from caffeonspark_tpu_torch import checkpoint
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetState, Phase
    npm = zoo_fn(batch_size=B)
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.LMDB"
    data.memory_data_param.source = os.path.join(workdir, "unused_lmdb")
    name = npm.name.lower()
    net_path = os.path.join(workdir, f"{name}_net.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{name}_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\nbase_lr: 0.01\nlr_policy: "fixed"\n')
    t0 = time.monotonic()
    net = Net(npm, NetState(phase=Phase.TEST), device="cpu")
    check(net.num_params() == 60_965_224,
          f"{npm.name}: {net.num_params()} params, expected 60,965,224")
    model = os.path.join(workdir, f"{name}.caffemodel")
    checkpoint.save_caffemodel(model, net, net.init(seed))
    del net
    log(f"  wrote {model} ({os.path.getsize(model) / 2**20:.1f} MiB, "
        f"{time.monotonic() - t0:.2f} s)")
    return solver_path, model


def post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read().decode())


def _stage_totals(svc):
    st = svc.metrics.summary()["stages"]
    return {k: (st[k]["total_s"], st[k]["count"]) for k in ("fwd", "pack")}


def serve_phase(K, torch, solver_path, model, env, rows_tol, label,
                sizes=(4, 4, 4, 4, 4, 4, B), device="cuda"):
    """Serve `model` through the CLI's start_server, answer one
    sequential /v1/predict call per entry of `sizes` (that many records
    each; a request of B records is one full flush at the B=64 shapes),
    and hold every row against the plain-kernel forward of the same
    batch."""
    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.serving.forward import fetch_rows
    with env_set(env):
        conf = Config(["-conf", solver_path, "-serve", "-model", model,
                       "-features", "fc8", "-device", device])
        conf.validate()
        t0 = time.monotonic()
        svc, httpd = caffe_on_spark.start_server(conf)
        boot_s = time.monotonic() - t0
    httpd.start_background()
    try:
        mv = svc.registry.current()
        want_wd = env.get("COS_SERVE_WEIGHT_DTYPE", "f32")
        check(mv.weight_dtype == want_wd,
              f"{label}: resident weights are {mv.weight_dtype}, expected "
              f"{want_wd} ({svc.registry.quant_fallback})")
        log(f"  {label}: boot (load + warm-up of buckets "
            f"{list(svc.batcher.buckets)}) {boot_s:.2f} s, weights "
            f"{mv.weight_dtype}, fused bias LRNs "
            f"{sorted(svc.registry.net.fused_bias_lrn)}")
        rng = np.random.RandomState(11)
        c, h, w = svc.source.image_dims()
        lat = {}
        worst = 0.0
        before = _stage_totals(svc)
        for r, n in enumerate(sizes):
            pix = rng.randint(0, 256, (n, c, h, w))
            recs = [{"id": f"r{r}_{i}", "data": pix[i].ravel().tolist()}
                    for i in range(n)]
            t1 = time.monotonic()
            out = post(httpd.port, {"records": recs})
            lat.setdefault(n, []).append(time.monotonic() - t1)
            rows = out["rows"]
            check(len(rows) == n and [x["SampleID"] for x in rows]
                  == [x["id"] for x in recs],
                  f"{label}: wrong rows for request {r}")
            got = np.asarray([x["fc8"] for x in rows], np.float32)
            check(got.shape == (n, 1000) and bool(np.isfinite(got).all()),
                  f"{label}: fc8 rows {got.shape} not finite (1000 wide)")
            records = [(x["id"], 0.0, c, h, w, False,
                        pix[i].astype(np.float32))
                       for i, x in enumerate(recs)]
            host = svc.source.next_batch(records)
            batch = {k: torch.from_numpy(v).to(svc.device)
                     for k, v in host.items()}
            fwd = svc.registry.forward(svc.blob_names,
                                       weight_dtype=mv.weight_dtype)
            with plain_kernels(K):
                ref_out = (fwd(mv.params, batch) if mv.weight_dtype == "f32"
                           else fwd(mv.params, mv.scales, batch))
            ref = np.asarray([x["fc8"] for x in fetch_rows(
                ref_out, ("fc8",), [x["id"] for x in recs], n, n)],
                np.float32)
            err = float(np.abs(got - ref).max()) / (
                float(np.abs(ref).max()) + 1e-30)
            worst = max(worst, err)
            check(err <= rows_tol,
                  f"{label}: request {r} rows differ from the plain path "
                  f"by {err:.3g} of max |fc8| (tol {rows_tol})")
        after = _stage_totals(svc)
        flushes = after["fwd"][1] - before["fwd"][1]
        check(flushes == len(sizes), f"{label}: {flushes} flushes for "
              f"{len(sizes)} requests")
        res = dict(label=label, boot_s=boot_s, rows_rel_err=worst,
                   flushes=flushes,
                   server_fwd_ms=1e3 * (after["fwd"][0]
                                        - before["fwd"][0]) / flushes,
                   server_pack_ms=1e3 * (after["pack"][0]
                                         - before["pack"][0]) / flushes)
        for n, ts in sorted(lat.items()):
            ms = sorted(1e3 * t for t in ts)
            res[f"request_{n}_ms"] = ms
            log(f"  {label}: {len(ms)} request(s) of {n} records: latency "
                f"median {ms[len(ms) // 2]:.2f} ms max {ms[-1]:.2f} ms, "
                f"{1e3 * n / ms[len(ms) // 2]:.1f} rows/s")
        log(f"  {label}: per flush (mean of {flushes} request flushes): "
            f"server forward {res['server_fwd_ms']:.2f} ms (H2D, net, "
            f"rows), pack {res['server_pack_ms']:.2f} ms; rows vs plain "
            f"path: max rel err {worst:.3g} (tol {rows_tol})")
        return res
    finally:
        httpd.stop()
        svc.stop(drain=True)


def profile_flush(torch, solver_path, model, env, label, device="cuda"):
    """One B=64 flush (pack, H2D, forward, rows) of a warmed service
    under torch.profiler: the device's busy time (union of kernel
    intervals) against the flush's wall time, the copy time, and the
    kernels that took most of it.  Runs after the launch counts were
    read, so its launches are not counted.  Returns None, and says why,
    when the profiler records no device activity."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.serving import InferenceService
    with env_set(env):
        svc = InferenceService(Config(["-conf", solver_path, "-model", model,
                                       "-features", "fc8", "-device",
                                       device]))
    c, h, w = svc.source.image_dims()
    rng = np.random.RandomState(5)
    recs = [(str(i), 0.0, c, h, w, False,
             rng.randint(0, 256, (c, h, w)).astype(np.float32))
            for i in range(B)]
    svc._run_batch(recs, B)                      # warm this shape
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:      # the profiler itself, not the program
        log(f"  {label}: profile: not measured ({e})")
        return None
    try:
        t0 = time.perf_counter()
        svc._run_batch(recs, B)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        prof.stop()
    return summarize_profile(prof, wall_us, label, f"one B={B} flush")


def summarize_profile(prof, wall_us, label, what):
    """Device busy time (union of kernel intervals) against the wall time
    of the profiled window, the copy time, and the kernels that took most
    of it; None, said so, when the profiler recorded no device kernels."""
    kernels, copies = [], 0.0
    runtime: dict = {}   # host-side CUDA runtime calls: [count, us]
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            if e.name.startswith("cuda"):
                r = runtime.setdefault(e.name, [0, 0.0])
                r[0] += 1
                r[1] += e.time_range.end - e.time_range.start
            continue
        span = (e.time_range.start, e.time_range.end)
        if "memcpy" in e.name.lower() or "memset" in e.name.lower():
            copies += span[1] - span[0]
        else:
            kernels.append((span, e.name))
    if not kernels:
        log(f"  {label}: profile: not measured (the profiler recorded no "
            "device kernels)")
        return None
    busy, end = 0.0, None
    for (a, b), _ in sorted(kernels):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict = {}
    for (a, b), name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the port's flash kernels (flash_{fwd,bwd_dq,bwd_dkv,carry}_kernel)
    flash_us = sum(us for name, us in by_name.items() if "flash_" in name)
    carry_us = sum(us for name, us in by_name.items() if "flash_carry" in name)
    # cuBLAS's GEMMs (Hopper names them nvjet_* or sm90_xmma_gemm_*)
    gemm_us = sum(us for name, us in by_name.items()
                  if any(t in name.lower() for t in GEMM_NAMES))
    res = dict(label=label, what=what, wall_us=wall_us, device_busy_us=busy,
               copy_us=copies, idle_share=1.0 - busy / wall_us,
               kernels=len(kernels), flash_us=flash_us,
               flash_share_of_busy=flash_us / busy, k9_us=carry_us,
               k9_share_of_busy=carry_us / busy, gemm_us=gemm_us,
               gemm_share_of_busy=gemm_us / busy,
               top=[[name[:60], us] for name, us in top],
               runtime={k: v for k, v in sorted(
                   runtime.items(), key=lambda kv: -kv[1][1])[:6]},
               cpu_top=[[a.key[:50], a.count, a.self_cpu_time_total]
                        for a in sorted(prof.key_averages(),
                                        key=lambda a: -a.self_cpu_time_total)
                        [:8]])
    log(f"  {label}: {what}: wall {wall_us:.0f} us, device busy "
        f"{busy:.0f} us in {len(kernels)} kernels (idle share "
        f"{res['idle_share']:.3f}), copies {copies:.0f} us, flash kernels "
        f"{flash_us:.0f} us ({res['flash_share_of_busy']:.3f} of busy; K9 "
        f"{carry_us:.0f} us, {res['k9_share_of_busy']:.3f}), GEMMs "
        f"{gemm_us:.0f} us ({res['gemm_share_of_busy']:.3f}); "
        "top: " +
        "; ".join(f"{n[:40]} {us:.0f} us" for n, us in top)
        + "; host runtime calls: " + "; ".join(
            f"{k} x{c} {us:.0f} us" for k, (c, us) in res["runtime"].items()))
    return res


# ---------------------------------------------------------------------------
# phases 8-12: train full-width nets through the CLI path
# ---------------------------------------------------------------------------

TRAIN_SOLVER = """net: "{net}"
base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 4
momentum: 0.9
weight_decay: 0.0005
max_iter: {max_iter}
snapshot: {snapshot}
snapshot_prefix: "{name}_train"
snapshot_after_train: {after}
random_seed: {seed}
{extra}"""
# the bvlc_reference_caffenet solver validates every 1000 steps over
# test_iter 1000 batches of 50; cut to two rounds of two batches
VAL_SOLVER = "test_interval: 4\ntest_iter: 2\n"
VAL_B, VAL_RECORDS, VAL_ROUNDS, VAL_ITER = 50, 100, 2, 2
INGEST_BATCHES = 4     # packed batches held equal across ingest settings
# the ingest runs: steps 3-8 as the other image-net runs, and the steady
# rate over steps 9-32, after the pool's window of batches packed ahead
# of the first step is spent, between the loss log's syncs at 8 and 32
# (a display every 8 steps); no snapshot in the way
INGEST_ITERS, STEADY_FROM = 32, 8
MEAN_VALUE = [104.0, 117.0, 123.0]


def write_train_data(workdir: str, name="train_lmdb", n=512,
                     seed=7) -> str:
    """`n` seeded 3x256x256 uint8 Datum records (labels in [0, 1000)) in
    an LMDB written with the port's own LmdbWriter."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch.data import LmdbWriter
    from caffeonspark_tpu_torch.proto.caffe import Datum
    path = os.path.join(workdir, name)
    shutil.rmtree(path, ignore_errors=True)
    rng = np.random.RandomState(seed)
    t0 = time.monotonic()
    recs = [(b"%08d" % i, Datum(
        channels=3, height=256, width=256,
        data=rng.randint(0, 256, 3 * 256 * 256, dtype=np.uint8).tobytes(),
        label=int(rng.randint(1000))).to_binary()) for i in range(n)]
    LmdbWriter(path).write(recs)
    log(f"  wrote {path}: {n} records of 3x256x256 "
        f"({time.monotonic() - t0:.2f} s)")
    return path


def write_train_config(workdir: str, zoo_fn, lmdb: str, seed: int,
                       test_lmdb: str = "", ingest: bool = False,
                       suffix: str = "") -> str:
    """train_val-style prototxts: the zoo's full-width net on an LMDB
    MemoryData layer (B=256, random 227 crop, mirror, mean_value) and
    the bvlc_reference_caffenet solver cut to max_iter 8.  With
    `test_lmdb`, the stock train_val shape: the data layer at TRAIN and
    a TEST one on `test_lmdb` (B=50, center crop 227, mean_value), and
    the solver validates (VAL_SOLVER); the net is renamed <name>Val.
    With `ingest`, INGEST_ITERS steps, no snapshot and a display every
    STEADY_FROM steps, where the loss log syncs (<name>Ingest);
    `suffix` renames the net (and its files) <name><suffix>."""
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import (NetParameter, NetState,
                                              NetStateRule, Phase,
                                              TransformationParameter)
    npm = zoo_fn(batch_size=TRAIN_B)
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.LMDB"
    data.memory_data_param.source = lmdb
    data.memory_data_param.height = 256
    data.memory_data_param.width = 256
    data.transform_param = TransformationParameter(
        crop_size=227, mirror=True, mean_value=MEAN_VALUE)
    if ingest:
        npm.name += "Ingest"
    npm.name += suffix
    if test_lmdb:
        npm.name += "Val"
        test = data.clone()
        data.include.append(NetStateRule(phase=Phase.TRAIN))
        test.include.append(NetStateRule(phase=Phase.TEST))
        test.memory_data_param.source = test_lmdb
        test.memory_data_param.batch_size = VAL_B
        test.transform_param = TransformationParameter(
            crop_size=227, mean_value=MEAN_VALUE)
        npm.layer.insert(1, test)
    name = npm.name.lower()
    net_path = os.path.join(workdir, f"{name}_train_val.prototxt")
    text = npm.to_text()
    check(NetParameter.from_text(text).layer[0].transform_param.crop_size
          == 227, f"{name}: transform_param did not survive the prototxt")
    n_params = Net(npm, NetState(phase=Phase.TRAIN), device="cpu").num_params()
    check(n_params == 60_965_224,
          f"{npm.name}: {n_params} params, expected 60,965,224")
    with open(net_path, "w") as f:
        f.write(text)
    solver_path = os.path.join(workdir, f"{name}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(TRAIN_SOLVER.format(
            net=net_path, max_iter=INGEST_ITERS if ingest else TRAIN_ITERS,
            snapshot=0 if ingest else 4,
            after="false" if ingest else "true", name=name, seed=seed,
            extra=(VAL_SOLVER if test_lmdb else "")
            + (f"display: {STEADY_FROM}\n" if ingest else "")))
    return solver_path


LM_SOLVER = """net: "{net}"
type: "Adam"
base_lr: 0.001
momentum: 0.9
momentum2: 0.999
delta: 1e-8
lr_policy: "fixed"
max_iter: {max_iter}
snapshot: 4
snapshot_prefix: "{name}_train"
snapshot_after_train: true
random_seed: 1
"""


def write_lm_config(workdir: str, lm=None, name=None) -> str:
    """64 JSON rows of 2,049 seeded tokens (vocab 1000; input = the first
    2,048, target = the last), the zoo's transformer_lm at the widths
    `lm` (default LM) on a DataFrameSource over them, and an Adam solver
    cut to max_iter 8; `name` renames the net (and its files and
    snapshots)."""
    lm = lm or LM
    import numpy as np
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetState, Phase
    rows = os.path.join(workdir, "lm_rows.json")
    rng = np.random.RandomState(17)
    t0 = time.monotonic()
    with open(rows, "w") as f:
        for _ in range(LM_ROWS):
            toks = rng.randint(0, lm["vocab"], lm["seq"] + 1).tolist()
            f.write(json.dumps({"input_sentence": toks[:-1],
                                "target_sentence": toks[1:]}) + "\n")
    npm = zoo.transformer_lm(**lm)
    if name:
        npm.name = name
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.DataFrameSource"
    data.cos_data_param.source = rows
    data.cos_data_param.dataframe_format = "json"
    n_params = Net(npm, NetState(phase=Phase.TRAIN), device="meta"
                   ).num_params()
    name = npm.name.lower()
    net_path = os.path.join(workdir, f"{name}_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{name}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(LM_SOLVER.format(net=net_path, max_iter=TRAIN_ITERS,
                                 name=name))
    log(f"  wrote {rows}: {LM_ROWS} rows of {lm['seq'] + 1} tokens "
        f"({time.monotonic() - t0:.2f} s); {npm.name} {lm}: "
        f"{n_params:,} parameters")
    return solver_path


@contextlib.contextmanager
def captured_batches(n):
    """The first `n` host batches the solver thread takes, copied (the
    processor's combine_batches wrapped for the run)."""
    import numpy as np
    from caffeonspark_tpu_torch import processor
    real = processor.combine_batches
    got = []

    def spy(batches, k, time_major=frozenset()):
        def tee():
            for b in batches:
                if len(got) < n:
                    got.append({key: np.array(v, copy=True)
                                for key, v in b.items()})
                yield b
        return real(tee(), k, time_major)

    processor.combine_batches = spy
    try:
        yield got
    finally:
        processor.combine_batches = real


@contextlib.contextmanager
def synced_folds():
    """(steps logged, host time) just after each fold of the processor's
    loss log, which synchronizes with the card: there the device has
    finished every step logged."""
    from caffeonspark_tpu_torch.processor import CaffeProcessor
    real = CaffeProcessor._fold_losses
    marks = []

    def fold(self):
        real(self)
        marks.append((len(self.train_log), time.perf_counter()))

    CaffeProcessor._fold_losses = fold
    try:
        yield marks
    finally:
        CaffeProcessor._fold_losses = real


def train_phase(K, label, solver_path, env, outdir, kernels,
                device="cuda", per_step=TRAIN_B, unit="images",
                launches_each=2 * TRAIN_ITERS, args=(), expect=None,
                rounds=0, capture=0, iters=TRAIN_ITERS, steady=False,
                first_loss=(6.0, 8.0), snapshots=True):
    """-train through caffe_on_spark.main (with the extra CLI `args`)
    with the counts zeroed just before and read just after; checks
    losses, snapshots and that each of `kernels` launched `launches_each`
    times (or as `expect` maps them) and no other kernel; with `rounds`,
    that validation.json holds that many rounds of finite accuracy and
    loss.  `per_step` `unit`s (images, tokens) make one step.  With
    `capture`, the record keeps that many of the first packed batches
    under "batches".  `iters` other than TRAIN_ITERS: a run without the
    snapshot checks; with `steady`, the record adds the steady step time
    over the steps after STEADY_FROM, between the loss log's syncs.
    `first_loss` bounds the first step's loss (a net with auxiliary
    losses weighs more than ln 1000).  `snapshots=False`: a solver that
    writes none (`no_snapshots`), whose files are not looked for."""
    import shutil
    from caffeonspark_tpu_torch import caffe_on_spark
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    metrics_path = os.path.join(outdir, "metrics.json")
    K.reset_launch_counts()
    t0 = time.monotonic()
    with env_set({**env, "COS_PIPELINE_METRICS": metrics_path}), \
            captured_batches(capture) as batches, synced_folds() as folds:
        rc = caffe_on_spark.main(["-conf", solver_path, "-train",
                                  "-output", outdir, "-device", device,
                                  *args])
    wall_s = time.monotonic() - t0
    counts = dict(K.launch_counts)
    check(rc == 0, f"{label}: -train returned {rc}")
    with open(metrics_path) as f:
        m = json.load(f)
    tr = m["info"]["train"]
    losses = tr["loss"]
    check(tr["iter"] == list(range(1, iters + 1)),
          f"{label}: iterations {tr['iter']}")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss in {losses}")
    check(first_loss[0] <= losses[0] <= first_loss[1],
          f"{label}: first loss {losses[0]:.4f} outside {first_loss}")
    name = os.path.basename(solver_path).split("_")[0]
    for it in ((4, TRAIN_ITERS) if iters == TRAIN_ITERS and snapshots
               else ()):
        for ext in ("caffemodel", "solverstate"):
            f = os.path.join(outdir, f"{name}_train_iter_{it}.{ext}")
            check(os.path.exists(f), f"{label}: no snapshot {f}")
    model = os.path.join(outdir, "model.caffemodel")
    check(os.path.exists(model), f"{label}: no final model {model}")
    want = {k: (launches_each if k in kernels else 0) for k in counts}
    want.update(expect or {})
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    validation = None
    if rounds:
        with open(os.path.join(outdir, "validation.json")) as f:
            validation = [json.loads(x) for x in f if x.strip()]
        check(len(validation) == rounds and all(
            sorted(r) == ["accuracy", "loss"]
            and all(math.isfinite(v) for v in r.values())
            for r in validation),
            f"{label}: validation rounds {validation}, expected {rounds} "
            "of finite accuracy and loss")
    t = tr["t"]
    steps_ms = sorted(1e3 * (t[i] - t[i - 1])
                      for i in range(2, min(len(t), TRAIN_ITERS)))
    med = steps_ms[len(steps_ms) // 2]
    st = m["stages"]
    # the steps of a COS_STEPS_PER_LOOP chunk share one timestamp: a
    # median interval of 0 reads no rate
    res = dict(label=label, wall_s=wall_s, losses=losses, lr=tr["lr"],
               step_interval_ms=steps_ms, median_step_ms=med,
               step_t=t,
               **{f"{unit}_per_s": 1e3 * per_step / med if med > 0
                  else None},
               pack_ms_p50=st["pack"]["p50_ms"],
               dispatch_ms_p50=st["step"]["p50_ms"],
               queue_wait_ms_p50=st["queue_wait"]["p50_ms"],
               stage_ms_p50=st["stage"]["p50_ms"],
               launches=counts)
    if validation is not None:
        res["validation"] = validation
    if steady:
        # from the sync after step STEADY_FROM to the sync after the last
        # step (a display every STEADY_FROM steps): device-finished steps
        at = {n: ts for n, ts in folds}
        check(STEADY_FROM in at and iters in at,
              f"{label}: no synchronized fold at steps {STEADY_FROM} and "
              f"{iters} ({sorted(at)})")
        ms = 1e3 * (at[iters] - at[STEADY_FROM]) / (iters - STEADY_FROM)
        res.update(steady_step_ms=ms,
                   **{f"steady_{unit}_per_s": 1e3 * per_step / ms})
    if capture:
        check(len(batches) == capture,
              f"{label}: {len(batches)} batches captured of {capture}")
        res["batches"] = batches
    log(f"  {label}: -train of {iters} steps in {wall_s:.1f} s; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"steps 3-{TRAIN_ITERS}: "
        f"median {med:.1f} ms ({res[f'{unit}_per_s'] or 0:.0f} {unit}/s), "
        f"pack p50 {res['pack_ms_p50']:.1f} ms, step dispatch p50 "
        f"{res['dispatch_ms_p50']:.1f} ms; launches {counts}"
        + (f"; validation {validation}" if validation else "")
        + (f"; steps {STEADY_FROM + 1}-{iters}: {res['steady_step_ms']:.1f}"
           f" ms a step ({res[f'steady_{unit}_per_s']:.0f} {unit}/s)"
           if steady else ""))
    return res, model


def eval_phase(K, label, solver_path, model, outdir, mode, kernels,
               launches_each, device="cuda"):
    """-test or -features fc8 (`mode`) of `model` through
    caffe_on_spark.main over the TEST data layer, with the counts zeroed
    just before and read just after (each of `kernels` launched
    `launches_each` times, no other kernel), then again with every
    kernel plain: the means (-test) or rows (-features) within
    ROWS_F32_TOL of the plain run's largest |value|."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark
    args = ["-test"] if mode == "test" else ["-features", "fc8"]
    out = {}
    for run in ("kernels", "plain"):
        d = os.path.join(outdir, run)
        shutil.rmtree(d, ignore_errors=True)
        K.reset_launch_counts()
        t0 = time.monotonic()
        with (plain_kernels(K) if run == "plain"
              else contextlib.nullcontext()):
            rc = caffe_on_spark.main(["-conf", solver_path, *args, "-model",
                                      model, "-output", d, "-device",
                                      device])
        check(rc == 0, f"{label}: -{mode} returned {rc}")
        if run == "kernels":
            wall_s = time.monotonic() - t0
            counts = dict(K.launch_counts)
        if mode == "test":
            with open(os.path.join(d, "test_result")) as f:
                out[run] = json.load(f)
        else:
            with open(os.path.join(d, "features.json")) as f:
                out[run] = [json.loads(x) for x in f if x.strip()]
    want = {k: (launches_each if k in kernels else 0) for k in counts}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    if mode == "test":
        got, ref = out["kernels"], out["plain"]
        check(sorted(got) == sorted(ref) == ["accuracy", "loss"],
              f"{label}: test_result keys {sorted(got)}")
        err = max(abs(got[k][0] - ref[k][0]) / max(abs(ref[k][0]), 1e-30)
                  for k in ref if k == "loss")
        check(all(math.isfinite(v[0]) for v in got.values()),
              f"{label}: non-finite test_result {got}")
        summary = dict(test_result=got, test_result_plain=ref)
    else:
        got, ref = out["kernels"], out["plain"]
        check(len(got) == len(ref) == VAL_RECORDS and [r["SampleID"] for r
              in got] == ["%08d" % i for i in range(VAL_RECORDS)],
              f"{label}: {len(got)} rows, expected {VAL_RECORDS} in order")
        g = np.asarray([r["fc8"] for r in got], np.float64)
        r_ = np.asarray([r["fc8"] for r in ref], np.float64)
        check(g.shape == (VAL_RECORDS, 1000) and np.isfinite(g).all(),
              f"{label}: fc8 rows {g.shape}, finite {np.isfinite(g).all()}")
        err = float(np.abs(g - r_).max() / np.abs(r_).max())
        summary = dict(rows=len(got), max_abs_fc8=float(np.abs(r_).max()))
    check(err <= ROWS_F32_TOL, f"{label}: -{mode} differs from the plain "
          f"run by {err:.3g} (tol {ROWS_F32_TOL})")
    log(f"  {label}: -{mode} in {wall_s:.1f} s, {err:.3g} of the plain "
        f"run's max (tol {ROWS_F32_TOL}); launches {counts}")
    return dict(label=label, mode=mode, wall_s=wall_s, rel_err=err,
                launches=counts, **summary)


def ingest_checks(torch, solver_path, runs, device="cuda"):
    """The five ingest settings of CaffeNet -train against each other:
    the first INGEST_BATCHES packed batches bit-equal between 0 and 2
    pool threads, and between the device-side transform's native crop,
    its numpy crop (COS_NATIVE=0) and its run at COS_STEPS_PER_LOOP=
    GRAPH_K; its uint8 + aux batches, run
    through its device stage on the card, within 1e-5 of the host
    transform's; every step's loss equal within STEP_LOSS_RTOL."""
    import numpy as np
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.data.source import get_source
    from caffeonspark_tpu_torch.data.transformer import DEVICE_AUX_SUFFIX
    inline, pooled, dx, dx_numpy, dx_graph = runs
    for x, y, what in ((inline, pooled, "the pool's and the inline "
                        "path's"), (dx, dx_numpy, "the native and the "
                        "numpy (COS_NATIVE=0) crop's"),
                       (dx, dx_graph, "K=1's and the graphed run's")):
        for a, b in zip(x["batches"], y["batches"]):
            check(sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in a),
                f"ingest: packed batches differ: {what}")
    conf = Config(["-conf", solver_path, "-train", "-device", device])
    stage = get_source(conf.train_data_layer(), phase_train=True
                       ).transformer.device_stage_fn()
    err = 0.0
    for a, b in zip(inline["batches"], dx["batches"]):
        check(b["data"].dtype == np.uint8
              and np.array_equal(a["label"], b["label"]),
              "ingest: the device-transform batch is not uint8 + labels")
        got = stage(torch.from_numpy(b["data"]).to(device),
                    torch.from_numpy(b["data" + DEVICE_AUX_SUFFIX]
                                     ).to(device))
        err = max(err, float((got.cpu() - torch.from_numpy(a["data"])
                              ).abs().max()))
    check(err <= 1e-5, f"ingest: the device stage differs from the host "
          f"transform by {err:.3g} (tol 1e-5)")
    worst = 0.0
    for r in (pooled, dx, dx_numpy, dx_graph):
        for x, y in zip(inline["losses"], r["losses"]):
            worst = max(worst, abs(x - y) / abs(x))
    check(worst <= STEP_LOSS_RTOL, f"ingest: step losses differ by "
          f"{worst:.3g} relative (tol {STEP_LOSS_RTOL})")
    log(f"  ingest: {INGEST_BATCHES} batches bit-equal (0 vs 2 threads; "
        "native vs numpy crop); "
        f"device stage within {err:.3g} of the host transform; losses "
        f"within {worst:.3g}")
    return dict(batches_equal=INGEST_BATCHES, device_stage_max_abs_err=err,
                loss_worst_rel=worst)


def _grad_diff(label, g_p, g_x, tol, what):
    """Worst per-blob max |g_x - g_p| / max |g_p|, checked against tol."""
    worst, worst_at = 0.0, ""
    for ln, bl in g_p.items():
        for bn, gp in bl.items():
            rel = float((g_x[ln][bn] - gp).abs().max()) / max(
                float(gp.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_at = rel, f"{ln}/{bn}"
            check(rel <= tol, f"{label}: {ln}/{bn} gradient {what} differs "
                  f"from the plain step by {rel:.3g} of its max")
    return worst, worst_at


def make_solver(torch, solver_path, env, device="cuda", dtype="float32"):
    """The Solver of a -train config at mini_cluster's -dtype `dtype`,
    and its first packed batch (source seed 1) on the host."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.solver import Solver
    with env_set(env):
        conf = Config(["-conf", solver_path, "-train", "-device", device])
        solver = Solver(conf.solverParameter, conf.netParam,
                        device=device, **solver_dtypes(torch, dtype))
    return solver, host_batches(conf, 1)[0]


def host_batches(conf, n):
    """The first `n` packed host batches of a config's TRAIN source
    (seed 1)."""
    import itertools
    from caffeonspark_tpu_torch.data.source import get_source
    src = get_source(conf.train_data_layer(), phase_train=True, seed=1)
    records = src.records()
    return [src.next_batch(list(itertools.islice(records, src.batch_size)))
            for _ in range(n)]


def step_vs_plain(K, torch, label, solver_path, env, device="cuda",
                  grad_tol=STEP_GRAD_TOL, plain_forwards=(), mesh=None,
                  dtype="float32", loss_rtol=STEP_LOSS_RTOL):
    """One solver step's loss and gradients with the kernels against the
    same step with every kernel swapped for its plain version: the same
    params, batch and dropout seed, cuDNN deterministic.  With
    `plain_forwards` (forward kernels' names), also the step with only
    those swapped, whose gradients must then match the plain step to
    STEP_GRAD_TOL: the backward kernels alone, in the net.  With a
    `mesh`, every step runs under its attention route (the sp ring), and
    the kernel step is also held against the same step without the mesh
    (loss `loss_rtol`, gradients `grad_tol`).  `dtype` is mini_cluster's
    -dtype (the batch cast as it casts it).  Returns the record and what
    the profile phase reuses."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.mini_cluster import cast_inputs
    from caffeonspark_tpu_torch.ops.layers import flash_mesh
    route = ((lambda: flash_mesh(mesh)) if mesh is not None
             else contextlib.nullcontext)
    solver, host = make_solver(torch, solver_path, env, device, dtype)
    batch = cast_inputs(solver.train_net, to_device(host, solver.device))
    params, state = solver.init()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        solver.generator.manual_seed(99)
        with route():
            loss_k, _, g_k = solver.loss_and_grads(params, batch)
        solver.generator.manual_seed(99)
        with plain_kernels(K), route():
            loss_p, _, g_p = solver.loss_and_grads(params, batch)
        g_b = None
        if plain_forwards:
            solver.generator.manual_seed(99)
            with plain_kernels(K, plain_forwards), route():
                _, _, g_b = solver.loss_and_grads(params, batch)
        if mesh is not None:
            solver.generator.manual_seed(99)
            loss_s, _, g_s = solver.loss_and_grads(params, batch)
    finally:
        torch.backends.cudnn.deterministic = prev
    lk, lp = float(loss_k), float(loss_p)
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_rel <= loss_rtol, f"{label}: loss {lk} with kernels, "
          f"{lp} plain (rel {loss_rel:.3g}, tol {loss_rtol:.3g})")
    worst, worst_at = _grad_diff(label, g_p, g_k, grad_tol, "")
    log(f"  {label}: loss {lk:.6f} with kernels, {lp:.6f} plain (rel "
        f"{loss_rel:.3g}); worst gradient {worst:.3g} of max |grad| at "
        f"{worst_at} (tol {grad_tol})")
    rec = dict(label=label, dtype=dtype, loss_kernel=lk, loss_plain=lp,
               loss_rel=loss_rel, loss_rtol=loss_rtol, worst_grad_rel=worst,
               worst_grad_at=worst_at, grad_tol=grad_tol)
    if g_b is not None:
        bwd_tol = STEP_GRAD_TOL if dtype == "float32" else grad_tol
        wb, wb_at = _grad_diff(label, g_p, g_b, bwd_tol,
                               "with plain forwards")
        log(f"  {label}: with {', '.join(plain_forwards)} plain and the "
            f"backward kernels: worst gradient {wb:.3g} of max |grad| at "
            f"{wb_at} (tol {bwd_tol})")
        rec.update(bwd_kernels_worst_grad_rel=wb,
                   bwd_kernels_worst_grad_at=wb_at)
    if mesh is not None:
        ls = float(loss_s)
        rel = abs(lk - ls) / abs(ls)
        check(rel <= loss_rtol, f"{label}: loss {lk} on the mesh, {ls} "
              f"without it (rel {rel:.3g})")
        ws, ws_at = _grad_diff(label, g_s, g_k, grad_tol,
                               "on the mesh against the single-device step")
        log(f"  {label}: against the single-device kernel step: loss "
            f"{ls:.6f} (rel {rel:.3g}); worst gradient {ws:.3g} of max "
            f"|grad| at {ws_at} (tol {grad_tol})")
        rec.update(loss_single=ls, single_loss_rel=rel,
                   single_worst_grad_rel=ws, single_worst_grad_at=ws_at)
    return rec, (solver, params, state, host)


def solver_dtypes(torch, dtype):
    """Solver dtypes of mini_cluster's -dtype."""
    return dict(dtype=torch.bfloat16 if dtype == "bfloat16"
                else torch.float32,
                compute_dtype=torch.bfloat16 if dtype == "mixed" else None)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def direct_steps(torch, solver, params, state, host, n=5, step=None):
    """ms of `n` training steps (`step`, default the solver's) called on
    this thread, each ended by a device synchronize (the step without
    the CLI's threads and queue)."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    step = step or solver.train_step
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, to_device(host, solver.device))
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def profile_train_step(torch, label, solver, params, state, host,
                       what=f"one B={TRAIN_B} training step", step=None):
    """One training step (`step`, default the solver's: H2D of a packed
    batch, forward, backward, update) of a warmed solver under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    step = step or solver.train_step
    sync = (torch.cuda.synchronize if solver.device.type == "cuda"
            else (lambda: None))
    step(params, state, to_device(host, solver.device))
    sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        log(f"  {label}: profile: not measured ({e})")
        return None
    try:
        t0 = time.perf_counter()
        step(params, state, to_device(host, solver.device))
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        prof.stop()
    return summarize_profile(prof, wall_us, label, what)


def wide_lm_phase(K, torch, workdir, key, lm):
    """The LM at fewer, wider heads (`lm`) through the CLI for TRAIN_ITERS
    steps (counts zeroed before, read after: K6, K7, K8 each layers x
    TRAIN_ITERS launches), one step against the all-plain step and the
    step with only K6 plain, 5 synchronized direct steps and one
    profiled step."""
    hd = lm["d_model"] // lm["heads"]
    name = f"TransformerLM{key}"
    label = f"TransformerLM {key} train"
    log(f"the LM at {lm['heads']} heads x {hd} through the CLI (-train, "
        f"DataFrameSource, {TRAIN_ITERS} Adam steps; counts zeroed "
        "before):")
    solver_path = write_lm_config(workdir, lm, name=name)
    train, _ = train_phase(
        K, label, solver_path, {},
        os.path.join(workdir, f"transformerlm_{key}_out"),
        ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv"),
        per_step=lm["batch"] * lm["seq"], unit="tokens",
        launches_each=lm["layers"] * TRAIN_ITERS)
    log(f"one head_dim-{hd} LM step with the kernels against the plain "
        "step and the step with only K6 plain:")
    step, (solver, params, state, host) = step_vs_plain(
        K, torch, label, solver_path, {}, grad_tol=LM_STEP_GRAD_TOL,
        plain_forwards=("flash_attention_fwd",))
    step["direct_step_ms"] = direct_steps(torch, solver, params, state, host)
    log(f"  {label}: {len(step['direct_step_ms'])} steps called directly "
        "on the main thread, each synchronized: "
        + ", ".join(f"{x:.1f}" for x in step["direct_step_ms"])
        + f" ms (median {median(step['direct_step_ms']):.1f})")
    log(f"profile of one head_dim-{hd} LM training step:")
    profile = profile_train_step(
        torch, label, solver, params, state, host,
        what=f"one B={lm['batch']} T={lm['seq']} {lm['heads']}x{hd} LM "
             "training step")
    return dict(train=train, launches=dict(train["launches"]), step=step,
                profile=profile)


# ---------------------------------------------------------------------------
# phases 17-21: the standalone trainer (mini_cluster) and -dtype
# ---------------------------------------------------------------------------

def loss_vs_f32(net, run, f32):
    """A -dtype run's losses against the float32 run's (the same seeded
    weights, batches and dropout draws): the first step's, before the
    trajectories part, to MIXED_VS_F32_LOSS_RTOL; every step's relative
    difference recorded."""
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                f32["losses"])]
    run["loss_rel_to_f32"] = rel
    check(rel[0] <= MIXED_VS_F32_LOSS_RTOL,
          f"{net} {run['dtype']}: first loss {run['losses'][0]} against "
          f"f32 {f32['losses'][0]} (rel {rel[0]:.3g}, tol "
          f"{MIXED_VS_F32_LOSS_RTOL:.3g})")
    log(f"  {net} {run['dtype']} against float32: first loss rel "
        f"{rel[0]:.3g} (tol {MIXED_VS_F32_LOSS_RTOL:.3g}), then "
        + ", ".join(f"{x:.3g}" for x in rel[1:]))


def mc_phase(K, label, solver_path, dtype, outdir, kernels, launches_each,
             env=None, args=(), iters=TRAIN_ITERS, device="cuda",
             display=1, first_loss=(6.0, 8.0)):
    """`python -m caffeonspark_tpu_torch.mini_cluster -dtype <dtype>` for
    `iters` steps with -metrics every `display` steps (each display step
    cuts the chunks of COS_STEPS_PER_LOOP) and -pipeline_metrics, the
    counts zeroed just before and read just after: every loss finite,
    the first near ln 1000, the snapshot at 4 (when the run gets there)
    and the final model, each of `kernels` launched `launches_each` times
    and no other kernel, every launch in bf16 unless -dtype float32."""
    import shutil
    from caffeonspark_tpu_torch import mini_cluster
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    steps_path = os.path.join(outdir, "steps.jsonl")
    pipe_path = os.path.join(outdir, "pipeline.json")
    K.reset_launch_counts()
    t0 = time.monotonic()
    with env_set(env or {}):
        rc = mini_cluster.main(
            ["-solver", solver_path, "-output", outdir, "-dtype", dtype,
             "-metrics", steps_path, "-display_every", str(display),
             "-pipeline_metrics", pipe_path, "-iterations", str(iters),
             "-device", device, *args])
    wall_s = time.monotonic() - t0
    counts = dict(K.launch_counts)
    by_dtype = {f"{k}:{d}": v for (k, d), v
                in sorted(K.launch_counts_by_dtype.items())}
    check(rc == 0, f"{label}: mini_cluster returned {rc}")
    with open(steps_path) as f:
        steps = [json.loads(x) for x in f if x.strip()]
    losses = [r["loss"] for r in steps]
    check([r["iter"] for r in steps]
          == list(range(display, iters + 1, display)),
          f"{label}: iterations {[r['iter'] for r in steps]}")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss in {losses}")
    check(display > 1 or first_loss[0] <= losses[0] <= first_loss[1],
          f"{label}: first loss {losses[0]:.4f} outside {first_loss}")
    name = os.path.basename(solver_path).split("_")[0]
    want_files = [f"{name}_train_iter_{iters}.caffemodel"]
    if iters >= 4:
        want_files += [f"{name}_train_iter_4.{e}"
                       for e in ("caffemodel", "solverstate")]
    for fname in want_files:
        check(os.path.exists(os.path.join(outdir, fname)),
              f"{label}: no {fname}")
    want = {k: (launches_each if k in kernels else 0) for k in counts}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    mode = "float32" if dtype == "float32" else "bfloat16"
    for k in kernels:
        check(by_dtype.get(f"{k}:{mode}", 0) == counts[k],
              f"{label}: {k} launches by dtype {by_dtype}, expected all "
              f"{counts[k]} in {mode}")
    with open(pipe_path) as f:
        stages = json.load(f)["stages"]
    res = dict(label=label, dtype=dtype, wall_s=wall_s, losses=losses,
               launches=counts, launches_by_dtype=by_dtype,
               dispatch_ms_p50=stages["step"]["p50_ms"],
               queue_wait_ms_p50=stages["queue_wait"]["p50_ms"],
               final_model=os.path.join(outdir, want_files[0]))
    if "scan_step" in stages:
        res["chunk_ms_p50"] = stages["scan_step"]["p50_ms"]
        res["chunks"] = stages["scan_step"]["count"]
    log(f"  {label}: mini_cluster -dtype {dtype}, {iters} steps in "
        f"{wall_s:.1f} s; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"step dispatch p50 {res['dispatch_ms_p50']:.1f} ms; launches "
        f"{by_dtype}")
    return res


def state_dtype_phase(K, torch, solver_path, workdir, device="cuda"):
    """COS_STATE_DTYPE=bfloat16 on the CaffeNet SGD solver through
    mini_cluster: 4 steps (snapshot at 4) with f32 params and bf16
    momentum, then a resume from the step-4 .solverstate for 2 more; the
    history is bf16 after both, the params f32 and finite.  Counts
    zeroed before the first run, read after the resume: K1 and K2
    2 x (4 + 2) launches each, in f32."""
    import shutil
    from caffeonspark_tpu_torch import mini_cluster
    out1 = os.path.join(workdir, "caffenet_state_out")
    out2 = os.path.join(workdir, "caffenet_state_resumed")
    for d in (out1, out2):
        shutil.rmtree(d, ignore_errors=True)
    K.reset_launch_counts()
    t0 = time.monotonic()
    with env_set({"COS_STATE_DTYPE": "bfloat16"}):
        mc = mini_cluster.MiniCluster(mini_cluster.build_argparser()
                                      .parse_args(
            ["-solver", solver_path, "-output", out1, "-iterations", "4",
             "-device", device]))
        check(mc.solver.state_dtype == torch.bfloat16,
              f"COS_STATE_DTYPE: state dtype {mc.solver.state_dtype}")
        mc.train()
        state = os.path.join(out1, "caffenet_train_iter_4.solverstate")
        check(os.path.exists(state), f"COS_STATE_DTYPE: no {state}")
        first = mc.final_state
        rs = mini_cluster.MiniCluster(mini_cluster.build_argparser()
                                      .parse_args(
            ["-solver", solver_path, "-output", out2, "-snapshot", state,
             "-iterations", "6", "-device", device]))
        rs.train()
    counts = dict(K.launch_counts)
    by_dtype = {f"{k}:{d}": v for (k, d), v
                in sorted(K.launch_counts_by_dtype.items())}
    for st, p, it in ((first, mc.final_params, 4),
                      (rs.final_state, rs.final_params, 6)):
        check(st.iter == it, f"COS_STATE_DTYPE: iter {st.iter}, not {it}")
        dts = {str(h.dtype) for bl in st.history.values()
               for h in bl.values()}
        check(dts == {"torch.bfloat16"},
              f"COS_STATE_DTYPE: history dtypes {dts} at iter {it}")
        check(all(w.dtype == torch.float32 and bool(torch.isfinite(w).all())
                  for bl in p.values() for w in bl.values()),
              f"COS_STATE_DTYPE: params not finite f32 at iter {it}")
    want = {k: (12 if k in ("lrn_across_channels",
                            "lrn_across_channels_bwd") else 0)
            for k in counts}
    check(counts == want, f"COS_STATE_DTYPE: launches {counts}, "
          f"expected {want}")
    hist_bytes = sum(h.numel() * h.element_size()
                     for bl in rs.final_state.history.values()
                     for h in bl.values())
    res = dict(label="CaffeNet COS_STATE_DTYPE=bfloat16",
               wall_s=time.monotonic() - t0, launches=counts,
               launches_by_dtype=by_dtype,
               history_dtype="bfloat16", history_bytes=hist_bytes,
               resumed_from=os.path.basename(state))
    log(f"  COS_STATE_DTYPE=bfloat16: 4 steps, snapshot, resume to 6: "
        f"history bf16 ({hist_bytes:,} bytes) after both; launches "
        f"{counts}")
    return res


def image_mc_phase(K, torch, workdir, train_configs, device="cuda"):
    """CaffeNet through mini_cluster in float32 and mixed (K1 / K2 16
    launches each, bf16 under mixed), AlexNet with
    COS_FUSE_BIAS_RELU_LRN=1 in mixed (K3 / K4, bf16), each mixed net's
    step against the same step with every kernel plain, and the
    COS_STATE_DTYPE run."""
    runs, steps = [], []
    for label, solver_path, env, kernels in train_configs:
        net = label.split()[0]
        for dtype in (("float32", "mixed") if net == "CaffeNet"
                      else ("mixed",)):
            runs.append(mc_phase(
                K, f"{net} mini_cluster {dtype}", solver_path, dtype,
                os.path.join(workdir, f"{net.lower()}_mc_{dtype}_out"),
                kernels, 2 * TRAIN_ITERS, env=env, device=device))
        f32 = [r for r in runs if r["label"] == f"{net} mini_cluster float32"]
        if f32:
            loss_vs_f32(net, runs[-1], f32[0])
        rec, kept = step_vs_plain(
            K, torch, f"{net} mixed", solver_path, env,
            grad_tol=MIXED_STEP_GRAD_TOL, loss_rtol=MIXED_STEP_LOSS_RTOL,
            dtype="mixed", device=device)
        steps.append(rec)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    state = state_dtype_phase(K, torch, train_configs[0][1], workdir,
                              device)
    return dict(runs=runs, step_vs_plain=steps, state_dtype=state)


def lm_dtype_phase(K, torch, workdir, lm_solver, mesh, device="cuda"):
    """The LM through mini_cluster in float32, mixed and bfloat16 (8
    steps each; K6-K8 16 launches each, in bf16 under mixed and
    bfloat16), the mixed and bfloat16 losses against the float32 ones
    (the same weights and batches), then per dtype 5 synchronized direct
    steps and one step under torch.profiler, the mixed step against the
    step with K6-K8 plain; then -mesh 1,1,4 -dtype mixed (MC_ITERS_SP
    steps, K9
    and K7/K8 in bf16) and one sp mixed step against the single-device
    mixed step and the all-plain step."""
    lm_kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    runs = {}
    for dtype in ("float32", "mixed", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        runs[dtype] = mc_phase(
            K, f"TransformerLM mini_cluster {dtype}", lm_solver, dtype,
            os.path.join(workdir, f"transformerlm_mc_{dtype}_out"),
            lm_kernels, LM["layers"] * TRAIN_ITERS, device=device)
    for dtype in ("mixed", "bfloat16"):
        loss_vs_f32("TransformerLM", runs[dtype], runs["float32"])
    direct, step_rec, profiles = {}, None, {}
    from caffeonspark_tpu_torch.mini_cluster import cast_inputs
    for dtype in ("float32", "mixed", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        if dtype == "mixed":
            step_rec, (solver, params, state, host) = step_vs_plain(
                K, torch, "TransformerLM mixed", lm_solver, {},
                grad_tol=MIXED_STEP_GRAD_TOL,
                loss_rtol=MIXED_STEP_LOSS_RTOL, dtype=dtype, device=device)
        else:     # the f32 step against plain: phase 13
            solver, host = make_solver(torch, lm_solver, {}, device, dtype)
            params, state = solver.init()

        def step(p, st, inputs, solver=solver):
            return solver.train_step(p, st, cast_inputs(solver.train_net,
                                                        inputs))

        direct[dtype] = direct_steps(torch, solver, params, state, host,
                                     step=step)
        log(f"  TransformerLM {dtype}: 5 direct synchronized steps: "
            + ", ".join(f"{x:.1f}" for x in direct[dtype])
            + f" ms (median {median(direct[dtype]):.1f})")
        profiles[dtype] = profile_train_step(
            torch, f"TransformerLM {dtype}", solver, params, state, host,
            what=f"one B={LM['batch']} T={LM['seq']} {dtype} LM step",
            step=step)
        del solver, params, state, host, step
    gc.collect()
    torch.cuda.empty_cache()
    hops = SP * (SP + 1) // 2
    sp_run = mc_phase(
        K, "TransformerLM mini_cluster sp4 mixed", lm_solver, "mixed",
        os.path.join(workdir, "transformerlm_mc_sp_out"),
        ("flash_block_update", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv"), LM["layers"] * hops * MC_ITERS_SP,
        args=("-mesh", f"1,1,{SP}"), iters=MC_ITERS_SP, device=device)
    sp_step, kept = step_vs_plain(
        K, torch, "TransformerLM sp4 mixed", lm_solver, {},
        grad_tol=MIXED_STEP_GRAD_TOL, loss_rtol=MIXED_STEP_LOSS_RTOL,
        plain_forwards=("flash_block_update",), mesh=mesh, dtype="mixed",
        device=device)
    del kept
    return dict(runs=runs, sp_run=sp_run, direct_step_ms=direct,
                direct_step_median_ms={k: median(v)
                                       for k, v in direct.items()},
                mixed_step_vs_plain=step_rec, sp_mixed_step=sp_step,
                profiles=profiles)


# ---------------------------------------------------------------------------
# phases 20-23: the native ingest library and COS_STEPS_PER_LOOP
# ---------------------------------------------------------------------------

GRAPH_K = 4              # COS_STEPS_PER_LOOP of the graphed runs
GRAPH_SP_K = 2           # ... of the sp4 mixed run (4 steps)
ENCODED_RECORDS = 512


def host_libraries() -> dict:
    """What the machine offers the ingest path: libjpeg (the native
    decoder builds), cv2 and PIL (with their versions)."""
    from caffeonspark_tpu_torch import native
    have = {"libjpeg": native.decode_available()}
    for mod in ("cv2", "PIL"):
        try:
            m = __import__(mod)
            have[mod] = getattr(m, "__version__", "present")
        except ImportError:
            have[mod] = None
    return have


def native_phase(torch, solver_path, ingest_runs):
    """The native crop/mirror at the training batch's shape, (256, 3,
    256, 256) uint8, crop 227 and mirror, against the numpy host_stage
    (COS_NATIVE=0): bit-equal, both timed (median of 5 calls); the
    feeder's own rate (LMDB read and Datum parse of 512 records on one
    thread); one uint8 pack (`next_batch` under the device-side
    transform) timed alone on this thread, native and numpy; and the two
    device-transform ingest runs (native crop, numpy crop): steady
    step, images/s and pack p50 of each."""
    import numpy as np
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.data.source import get_source
    from caffeonspark_tpu_torch.data.transformer import Transformer
    from caffeonspark_tpu_torch.proto import TransformationParameter
    tp = TransformationParameter(crop_size=227, mirror=True,
                                 mean_value=MEAN_VALUE)
    x = np.random.RandomState(5).randint(0, 256, (TRAIN_B, 3, 256, 256)
                                         ).astype(np.uint8)
    out, ms = {}, {}
    for key, env in (("native", {}), ("numpy", {"COS_NATIVE": "0"})):
        t = Transformer(tp, phase_train=True, seed=3)
        times = []
        with env_set(env):
            for i in range(6):
                draw = t.draw(TRAIN_B, 256, 256)
                t0 = time.perf_counter()
                u8, aux = t.host_stage(x, draw)
                times.append(1e3 * (time.perf_counter() - t0))
                if i == 0:
                    out[key] = (u8, aux)
        ms[key] = median(times[1:])
    check(np.array_equal(out["native"][0], out["numpy"][0])
          and np.array_equal(out["native"][1], out["numpy"][1]),
          "native crop_mirror_u8 differs from the numpy host_stage")
    conf = Config(["-conf", solver_path, "-train", "-device", "cpu"])
    src = get_source(conf.train_data_layer(), phase_train=True, seed=1)
    t0 = time.perf_counter()
    records = list(src.records())
    feed_s = time.perf_counter() - t0
    n = len(records)
    alone = {}     # one uint8 pack (next_batch) with no other thread
    for key, env in (("native", {}), ("numpy", {"COS_NATIVE": "0"})):
        with env_set({**env, "COS_DEVICE_TRANSFORM": "1"}):
            src.enable_device_transform()
            times = []
            for i in range(4):
                t0 = time.perf_counter()
                src.next_batch(records[i * 64:i * 64 + TRAIN_B]
                               if i * 64 + TRAIN_B <= n
                               else records[:TRAIN_B])
                times.append(1e3 * (time.perf_counter() - t0))
        alone[key] = median(times[1:])
    del records
    runs = {r["label"]: {k: r[k] for k in ("steady_step_ms",
                                           "steady_images_per_s",
                                           "pack_ms_p50", "stage_ms_p50")}
            for r in ingest_runs if "device transform" in r["label"]}
    res = dict(shape=[TRAIN_B, 3, 256, 256], crop=227, bit_equal=True,
               native_ms=ms["native"], numpy_ms=ms["numpy"],
               threads=os.cpu_count(), feeder_records=n,
               pack_alone_ms=alone,
               feeder_records_per_s=n / feed_s,
               feeder_batches_per_s=n / feed_s / TRAIN_B, runs=runs)
    log(f"  native crop/mirror (256,3,256,256) crop 227: bit-equal to "
        f"numpy; {ms['native']:.2f} ms against {ms['numpy']:.2f} ms "
        f"({os.cpu_count()} cores); feeder (LMDB read + Datum parse, one "
        f"thread): {res['feeder_records_per_s']:.0f} records/s "
        f"({res['feeder_batches_per_s']:.1f} batches of {TRAIN_B}/s); "
        f"one uint8 pack alone: {alone['native']:.1f} ms native, "
        f"{alone['numpy']:.1f} ms numpy; "
        + "; ".join(f"{k}: {v['steady_step_ms']:.1f} ms a step, pack p50 "
                    f"{v['pack_ms_p50']:.1f} ms" for k, v in runs.items()))
    return res


def write_encoded_data(workdir: str, have: dict) -> str:
    """ENCODED_RECORDS seeded 3x256x256 images encoded as JPEG (quality
    90) with the machine's encoder (cv2, else PIL) in Datums flagged
    encoded, written with the port's LmdbWriter; None without an
    encoder."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch.data import LmdbWriter
    from caffeonspark_tpu_torch.proto.caffe import Datum
    if have["cv2"]:
        import cv2

        def encode(img):
            ok, buf = cv2.imencode(".jpg", img,
                                   [cv2.IMWRITE_JPEG_QUALITY, 90])
            check(ok, "cv2 could not encode a JPEG")
            return bytes(buf)
    elif have["PIL"]:
        import io

        from PIL import Image

        def encode(img):
            buf = io.BytesIO()
            Image.fromarray(img[:, :, ::-1]).save(buf, "JPEG", quality=90)
            return buf.getvalue()
    else:
        return None
    path = os.path.join(workdir, "encoded_lmdb")
    shutil.rmtree(path, ignore_errors=True)
    rng = np.random.RandomState(23)
    t0 = time.monotonic()
    recs = []
    for i in range(ENCODED_RECORDS):
        img = rng.randint(0, 256, (256, 256, 3), dtype=np.uint8)
        recs.append((b"%08d" % i, Datum(
            channels=3, height=256, width=256, encoded=True,
            data=encode(img), label=int(rng.randint(1000))).to_binary()))
    LmdbWriter(path).write(recs)
    size = sum(len(v) for _, v in recs)
    log(f"  wrote {path}: {ENCODED_RECORDS} JPEG Datums of 3x256x256 "
        f"({size / 2**20:.1f} MiB, {time.monotonic() - t0:.2f} s)")
    return path


def encoded_phase(K, torch, workdir, have, kernels):
    """An LMDB of encoded Datums: CaffeNet -train for TRAIN_ITERS steps on
    it under cuDNN deterministic (first loss near ln 1000, every loss
    finite, K1 / K2 2 x TRAIN_ITERS launches each; counts zeroed before,
    read after; its LMDB, final model and first packed batch are phase
    31's reference, under "reference", which main pops); the
    decode of one batch timed; uint8 decoding equal to the float decode
    cast.  Without libjpeg the native decoder must refuse by name (the
    records then go through cv2); without any encoder, the port must
    refuse an encoded record by name."""
    import numpy as np
    from caffeonspark_tpu_torch import native
    from caffeonspark_tpu_torch.data.source import (datum_to_record,
                                                    decode_records)
    from caffeonspark_tpu_torch.data.lmdb_io import LmdbReader
    path = write_encoded_data(workdir, have)
    if path is None:
        rec = ("r0", 1.0, 3, 8, 8, True, b"\xff\xd8\xff")
        try:
            decode_records([rec], 3, 8, 8)
        except RuntimeError as e:
            check("libjpeg" in str(e) and "cv2" in str(e),
                  f"encoded records: refusal {e} names neither libjpeg nor "
                  "cv2")
            log(f"  no JPEG encoder here: an encoded record is refused: {e}")
            return dict(encoder=None, refused=str(e))
        check(False, "an encoded record was decoded with no decoder")
    decoder = "native libjpeg" if have["libjpeg"] else "cv2"
    if not have["libjpeg"]:
        try:
            native.decode_batch([b"x"], channels=3, out_h=8, out_w=8)
            check(False, "native.decode_batch ran without libjpeg")
        except native.LibjpegMissing as e:
            check("libjpeg" in str(e), f"refusal {e} does not name libjpeg")
            log(f"  no libjpeg here: the native decoder refuses by name "
                f"({str(e)[:80]}...); the records go through cv2")
    with LmdbReader(path) as r:
        recs = [datum_to_record(k, v) for k, v in r.items(None, None)]
    batch = recs[:TRAIN_B]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        f32 = decode_records(batch, 3, 256, 256, dtype=np.float32,
                             num_threads=0)
        times.append(1e3 * (time.perf_counter() - t0))
    u8 = decode_records(batch, 3, 256, 256, dtype=np.uint8, num_threads=0)
    check(np.array_equal(u8, f32.astype(np.uint8)),
          "the uint8 decode differs from the float decode cast")
    from caffeonspark_tpu_torch.models import zoo
    solver = write_train_config(workdir, zoo.caffenet, path, seed=1,
                                suffix="Encoded")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # phase 31's reference
    try:
        train, model = train_phase(
            K, f"CaffeNet encoded ({decoder})", solver, {},
            os.path.join(workdir, "caffenet_encoded_out"), kernels,
            capture=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = dict(lmdb=path, model=model, batch=train.pop("batches")[0],
               **{k: train[k] for k in ("median_step_ms", "pack_ms_p50",
                                         "wall_s")})
    res = dict(encoder="cv2" if have["cv2"] else "PIL", decoder=decoder,
               decode_batch_ms=median(times), decode_batch=TRAIN_B,
               u8_equals_float_cast=True, train=train, reference=ref)
    log(f"  encoded: {decoder} decodes {TRAIN_B} JPEGs of 256x256 in "
        f"{res['decode_batch_ms']:.1f} ms (median of 3; uint8 = float "
        "cast)")
    return res


def chunk_block(torch, host, k, device):
    """A packed host batch stacked k times: the (k, batch...) block of a
    chunk, on `device`."""
    import numpy as np
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    return to_device({key: np.stack([v] * k) for key, v in host.items()},
                     device)


def graph_lm_phase(K, torch, workdir, lm_solver, lm_mc, device="cuda"):
    """The LM through mini_cluster at COS_STEPS_PER_LOOP=GRAPH_K in
    float32, mixed and bfloat16 (8 steps, display 4: an eager warm-up
    chunk, then the captured graph's replay; K6-K8 16 launches each,
    replays counted), final params bit-equal to the K=1 run of the same
    dtype (phase 19); per dtype 5 synchronized direct chunks (per step =
    chunk / GRAPH_K) and one replayed chunk under torch.profiler.  Then
    -mesh 1,1,4 -dtype mixed at COS_STEPS_PER_LOOP=GRAPH_SP_K against
    the same run at K=1 (4 steps each), final params bit-equal."""
    from caffeonspark_tpu_torch.mini_cluster import cast_inputs
    lm_kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    runs, equal, chunks, profiles = {}, {}, {}, {}
    for dtype in ("float32", "mixed", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        run = mc_phase(
            K, f"TransformerLM mini_cluster {dtype} K={GRAPH_K}", lm_solver,
            dtype, os.path.join(workdir, f"transformerlm_mc_{dtype}_k_out"),
            lm_kernels, LM["layers"] * TRAIN_ITERS, device=device,
            env={"COS_STEPS_PER_LOOP": str(GRAPH_K)}, display=GRAPH_K)
        check(run.get("chunks") == TRAIN_ITERS // GRAPH_K,
              f"{run['label']}: {run.get('chunks')} chunks")
        with open(run["final_model"], "rb") as a, \
                open(lm_mc["runs"][dtype]["final_model"], "rb") as b:
            equal[dtype] = a.read() == b.read()
        check(equal[dtype], f"{run['label']}: the final model differs from "
              "the K=1 run's")
        runs[dtype] = run
        solver, host = make_solver(torch, lm_solver, {}, device, dtype)
        params, state = solver.init()
        many = solver.train_step_many(GRAPH_K)
        block = chunk_block(torch, host, GRAPH_K, device)

        def chunk(p, st, inputs, many=many, net=solver.train_net):
            return many(p, st, cast_inputs(net, inputs))

        for _ in range(2):        # the eager warm-up, the capture
            chunk(params, state, block)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk(params, state, block)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        check(many.captures == 1 and many.replays == 6,
              f"graphed {dtype} chunks: {many.captures} captures, "
              f"{many.replays} replays")
        chunks[dtype] = dict(chunk_ms=ms, step_ms=median(ms) / GRAPH_K)
        log(f"  TransformerLM {dtype} K={GRAPH_K}: 5 synchronized graphed "
            "chunks: " + ", ".join(f"{x:.1f}" for x in ms)
            + f" ms ({chunks[dtype]['step_ms']:.2f} ms a step; K=1 "
            f"{lm_mc['direct_step_median_ms'][dtype]:.2f})")
        profiles[dtype] = profile_train_step(
            torch, f"TransformerLM {dtype} K={GRAPH_K}", solver, params,
            state, {k: v.cpu().numpy() for k, v in block.items()},
            what=f"one graphed chunk of {GRAPH_K} {dtype} LM steps",
            step=chunk)
        del solver, params, state, host, block, many, chunk
    gc.collect()
    torch.cuda.empty_cache()
    hops = SP * (SP + 1) // 2
    sp = {}
    for k in (GRAPH_SP_K, 1):
        sp[k] = mc_phase(
            K, f"TransformerLM mini_cluster sp4 mixed K={k}", lm_solver,
            "mixed", os.path.join(workdir, f"transformerlm_mc_sp_k{k}_out"),
            ("flash_block_update", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"), LM["layers"] * hops * 4,
            args=("-mesh", f"1,1,{SP}"), iters=4, device=device,
            env={"COS_STEPS_PER_LOOP": str(k)}, display=GRAPH_SP_K)
    with open(sp[GRAPH_SP_K]["final_model"], "rb") as a, \
            open(sp[1]["final_model"], "rb") as b:
        sp_equal = a.read() == b.read()
    check(sp_equal, "sp4 mixed: the graphed run's final model differs from "
          "the K=1 run's")
    log(f"  sp4 mixed K={GRAPH_SP_K}: final model bit-equal to K=1")
    return dict(runs=runs, final_params_equal_k1=equal, chunks=chunks,
                profiles=profiles, sp_run=sp[GRAPH_SP_K], sp_run_k1=sp[1],
                sp_final_params_equal_k1=sp_equal)


GRAPH_SOLVER_CUTS = dict(max_iter=16, test_interval=8, snapshot=6)


def graph_caffenet_phase(K, torch, workdir, lmdb, test_lmdb, kernels,
                         train_solver):
    """Validating CaffeNet through the CLI at COS_STEPS_PER_LOOP=GRAPH_K
    and at 1, 16 steps, test_interval 8 (test_iter 2), snapshot 6: the
    schedule 4, 1, 1, 1, 1, 4, 4 (an eager warm-up chunk, single-step
    remainders before the snapshot at 6 and the round at 8, then the
    graph captured and replayed).  cuDNN deterministic: every loss
    equal, validation.json and the snapshots at 6 and 12 and the final
    model byte-equal, the same launches (replays counted).  Then on
    `train_solver`'s CaffeNet (f32, B=256) 5 synchronized direct steps
    against 5 synchronized direct graphed chunks."""
    from caffeonspark_tpu_torch.models import zoo
    base = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                              test_lmdb=test_lmdb)
    with open(base) as f:
        text = f.read()
    for key, v in GRAPH_SOLVER_CUTS.items():
        text = "\n".join(f"{key}: {v}" if line.startswith(f"{key}:")
                         else line for line in text.splitlines()) + "\n"
    solver = base.replace("_solver.prototxt", "_graph_solver.prototxt")
    with open(solver, "w") as f:
        f.write(text)
    iters = GRAPH_SOLVER_CUTS["max_iter"]
    val_lrn = 2 * iters + 2 * VAL_ITER * 2
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for k in (GRAPH_K, 1):
            runs[k], _ = train_phase(
                K, f"CaffeNet validating K={k}", solver,
                {"COS_STEPS_PER_LOOP": str(k)},
                os.path.join(workdir, f"caffenet_graph_k{k}_out"), kernels,
                expect={kernels[0]: val_lrn, kernels[1]: 2 * iters},
                rounds=2, iters=iters)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    g, e = runs[GRAPH_K], runs[1]
    check(g["losses"] == e["losses"], f"graphed CaffeNet losses "
          f"{g['losses']} differ from K=1's {e['losses']}")
    check(g["validation"] == e["validation"],
          "graphed CaffeNet validation.json differs from K=1's")
    check(g["launches"] == e["launches"], f"graphed CaffeNet launches "
          f"{g['launches']} differ from K=1's {e['launches']}")
    name = "caffenetval"
    files = [f"{name}_train_iter_{i}.{x}" for i in (6, 12)
             for x in ("caffemodel", "solverstate")] + ["model.caffemodel"]
    for fname in files:
        paths = [os.path.join(workdir, f"caffenet_graph_k{k}_out", fname)
                 for k in (GRAPH_K, 1)]
        check(all(os.path.exists(p) for p in paths), f"no {fname}")
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            check(a.read() == b.read(), f"graphed CaffeNet {fname} differs "
                  "from K=1's")
    log(f"  CaffeNet K={GRAPH_K} against K=1: losses, validation rounds, "
        f"launches and {', '.join(files)} equal")
    gc.collect()
    torch.cuda.empty_cache()
    solver_t, host = make_solver(torch, train_solver, {})
    params, state = solver_t.init()
    k1 = direct_steps(torch, solver_t, params, state, host)
    many = solver_t.train_step_many(GRAPH_K)
    block = chunk_block(torch, host, GRAPH_K, solver_t.device)
    for _ in range(2):            # the eager warm-up, the capture
        many(params, state, block)
    chunk_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many(params, state, block)
        torch.cuda.synchronize()
        chunk_ms.append(1e3 * (time.perf_counter() - t0))
    direct = dict(k1_step_ms=k1, chunk_ms=chunk_ms,
                  step_ms=median(chunk_ms) / GRAPH_K)
    log(f"  CaffeNet B={TRAIN_B} f32: 5 synchronized steps "
        + ", ".join(f"{x:.1f}" for x in k1) + " ms; 5 synchronized graphed "
        f"chunks of {GRAPH_K}: " + ", ".join(f"{x:.1f}" for x in chunk_ms)
        + f" ms ({direct['step_ms']:.2f} ms a step against "
        f"{median(k1):.2f})")
    del solver_t, params, state, host, many, block
    return dict(runs={str(k): v for k, v in runs.items()},
                schedule=[4, 1, 1, 1, 1, 4, 4], equal_to_k1=True,
                files_equal=files, direct=direct)


# ---------------------------------------------------------------------------
# phases 23-27: the wider zoo, write-behind and HDF5 snapshots, the quant
# sidecar
# ---------------------------------------------------------------------------

ZOO_B, ZOO_CROP = 32, 224     # the published ImageNet train_val batch/crop
# bvlc_googlenet quick_solver.prototxt (max_iter 2,400,000, snapshot
# 40,000 cut to 8 and 4)
GOOGLENET_SOLVER = ('base_lr: 0.01\nlr_policy: "poly"\npower: 0.5\n'
                    'momentum: 0.9\nweight_decay: 0.0002\n')
# He et al. 2016 section 3.4; Simonyan & Zisserman 2015 section 3.1
RESNET_SOLVER = ('base_lr: 0.1\nlr_policy: "fixed"\nmomentum: 0.9\n'
                 'weight_decay: 0.0001\n')
VGG_SOLVER = ('base_lr: 0.01\nlr_policy: "fixed"\nmomentum: 0.9\n'
              'weight_decay: 0.0005\n')
# the -test model's solver: the published lr cut 1000 times, so that its
# TRAIN_ITERS forwards gather the running statistics at nearly the
# weights it ends with and its TEST loss is that of a net whose
# statistics fit (the lr 0.1 model's statistics were gathered at weights
# it has left: its TEST loss was 1.4e12 on the H100)
RESNET_FIT_SOLVER = RESNET_SOLVER.replace("base_lr: 0.1\n",
                                          "base_lr: 0.0001\n")
# -test on the card against the CPU port's -test of the same model and
# records (the CPU TEST forward is held to the JAX package's by
# tests/test_torch_batchnorm.py): the loss relative, the accuracy within
# one record
TEST_VS_CPU_RTOL = 1e-3
# the weighted sum of the main loss and two auxiliary losses of weight
# 0.3: 1.6 ln 1000 = 11.05 at zero logits; with the published xavier
# fillers on raw mean-subtracted pixels the towers start higher (18.3 at
# B=4 on the CPU, the main loss 7.3)
GOOGLENET_FIRST_LOSS = (10.0, 30.0)
# ResNet-50's residual sums grow the logits past ln 1000's zero-logit
# loss (8.1-9.0 at B=2, crop 64 on the CPU)
RESNET_FIRST_LOSS = (6.0, 12.0)
# VGG-16's fc6/fc7 biases of 1 and the dropout's 2x scale spread the
# logits (9.46 at B=2, crop 64 on the CPU)
VGG_FIRST_LOSS = (6.0, 12.0)
ZOO_PARAMS = {"GoogLeNet": (6_500_000, 14_000_000),
              "ResNet50": (25_500_000, 25_700_000),
              "VGG16": (138_357_544, 138_357_544)}


def write_zoo_config(workdir, zoo_fn, lmdb, solver_lines, seed,
                     name=None, test_lmdb="", extra="", max_iter=TRAIN_ITERS,
                     snapshot=4, xavier_convs=False):
    """The zoo net at its published width on the LMDB MemoryData layer
    (B=ZOO_B, random ZOO_CROP crop of the 256x256 records, mirror,
    mean_value 104/117/123: bvlc_googlenet's train_val data shape), with
    a TEST layer on `test_lmdb` when given (B=VAL_B, center crop; the
    solver does not validate, so -test reads it), and a solver of
    `solver_lines` cut to `max_iter` and `snapshot`.  `xavier_convs`
    gives every convolution the published bvlc_googlenet's xavier weight
    filler: the zoo draws gaussian weights at the published std values,
    from which GoogLeNet's first loss is near 49 on raw pixels and the
    quick_solver diverges within two steps (measured on the CPU)."""
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import (NetState, NetStateRule, Phase,
                                              TransformationParameter)
    from caffeonspark_tpu_torch.proto import FillerParameter
    npm = zoo_fn(batch_size=ZOO_B)
    if name:
        npm.name = name
    if xavier_convs:
        for lp in npm.layer:
            if lp.type == "Convolution":
                lp.convolution_param.weight_filler = FillerParameter(
                    type="xavier")
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.LMDB"
    data.memory_data_param.source = lmdb
    data.memory_data_param.height = 256
    data.memory_data_param.width = 256
    data.transform_param = TransformationParameter(
        crop_size=ZOO_CROP, mirror=True, mean_value=MEAN_VALUE)
    if test_lmdb:
        test = data.clone()
        data.include.append(NetStateRule(phase=Phase.TRAIN))
        test.include.append(NetStateRule(phase=Phase.TEST))
        test.memory_data_param.source = test_lmdb
        test.memory_data_param.batch_size = VAL_B
        test.transform_param = TransformationParameter(
            crop_size=ZOO_CROP, mean_value=MEAN_VALUE)
        npm.layer.insert(1, test)
    lname = npm.name.lower()
    net = Net(npm, NetState(phase=Phase.TRAIN), device="meta")
    stats = set(net.stat_param_layers())
    weights = sum(math.prod(s) for ln, specs in net.param_layout.items()
                  if ln not in stats for _, s, _ in specs)
    lo, hi = ZOO_PARAMS[zoo_fn(batch_size=1).name]
    check(lo <= weights <= hi, f"{npm.name}: {weights:,} weights outside "
          f"[{lo:,}, {hi:,}]")
    net_path = os.path.join(workdir, f"{lname}_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{lname}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\n{solver_lines}max_iter: {max_iter}\n'
                f'snapshot: {snapshot}\nsnapshot_prefix: "{lname}_train"\n'
                f'snapshot_after_train: true\nrandom_seed: {seed}\n{extra}')
    return solver_path, weights, len(stats)


@contextlib.contextmanager
def timed_snapshots():
    """The wall time of each snapshot call on the solver thread (the
    processor's `_snapshot`: the whole write, or under -async_snapshot
    the host copy and the wait for the write before it)."""
    from caffeonspark_tpu_torch.processor import CaffeProcessor
    real = CaffeProcessor._snapshot
    calls = []

    def timed(self, params, st, final=False):
        t0 = time.perf_counter()
        real(self, params, st, final=final)
        calls.append(dict(iter=st.iter, final=final,
                          ms=1e3 * (time.perf_counter() - t0)))

    CaffeProcessor._snapshot = timed
    try:
        yield calls
    finally:
        CaffeProcessor._snapshot = real


def files_equal(label, dir_a, dir_b, names):
    for fname in names:
        paths = [os.path.join(d, fname) for d in (dir_a, dir_b)]
        check(all(os.path.exists(p) for p in paths), f"{label}: no {fname}")
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            check(a.read() == b.read(), f"{label}: {fname} differs")


def zoo_direct_steps(torch, label, solver_path, kept=None, device="cuda"):
    """The net's step without the CLI's threads: one warm-up step, then
    5 synchronized direct steps (`direct_steps`); `kept` is a
    step_vs_plain's (solver, params, state, host), else a fresh solver
    at its seed's init."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    if kept is None:
        solver, host = make_solver(torch, solver_path, {}, device)
        params, state = solver.init()
    else:
        solver, params, state, host = kept
    solver.train_step(params, state, to_device(host, solver.device))
    ms = direct_steps(torch, solver, params, state, host)
    log(f"  {label}: 5 synchronized direct steps "
        + ", ".join(f"{x:.1f}" for x in ms) + f" ms (median {median(ms):.1f})")
    return ms


def googlenet_phase(K, torch, workdir, lmdb, res, device="cuda"):
    """GoogLeNet (bvlc_googlenet, aux towers included) at B=ZOO_B, crop
    ZOO_CROP through the CLI for TRAIN_ITERS steps: K1 + K2 on norm1
    (32,64,56,56) and norm2 (32,192,56,56), 16 launches each; then with
    COS_FUSE_BIAS_RELU_LRN=1, where the peephole folds conv2/3x3's bias
    and relu into norm2 (K3 + K4) and norm1 stays K1 + K2 (8 each);
    each net's step against the all-plain step (STEP_LOSS_RTOL,
    STEP_GRAD_TOL); K1-K3 timed at these shapes into `res` (K4 at
    norm2's shape: phase 3)."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.net import Net
    solver, weights, _ = write_zoo_config(workdir, zoo.googlenet, lmdb,
                                          GOOGLENET_SOLVER, seed=3,
                                          xavier_convs=True)
    with env_set({"COS_FUSE_BIAS_RELU_LRN": "1"}):
        conf = Config(["-conf", solver, "-train", "-device", "cpu"])
        fused = Net(conf.netParam, device="meta").fused_bias_lrn
    check(fused == {"conv2_norm2": "conv2/3x3"},
          f"GoogLeNet: the bias peephole matched {fused}")
    lrn = ("lrn_across_channels", "lrn_across_channels_bwd")
    blrn = ("bias_relu_lrn_across_channels",
            "bias_relu_lrn_across_channels_bwd")
    runs, steps = {}, []
    for key, env, kernels, expect in (
            ("plain_lrn", {}, lrn, None),
            ("bias_relu_lrn", {"COS_FUSE_BIAS_RELU_LRN": "1"}, lrn + blrn,
             {k: TRAIN_ITERS for k in lrn + blrn})):
        label = f"GoogLeNet train {key.replace('_', ' ')}"
        runs[key], _ = train_phase(
            K, label, solver, env,
            os.path.join(workdir, f"googlenet_{key}_out"), kernels,
            per_step=ZOO_B, expect=expect, first_loss=GOOGLENET_FIRST_LOSS,
            device=device)
        rec, kept = step_vs_plain(K, torch, label, solver, env,
                                  device=device)
        with env_set(env):
            rec["direct_step_ms"] = zoo_direct_steps(torch, label, solver,
                                                     kept, device)
        steps.append(rec)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
    log("  K1-K3 at GoogLeNet's norm shapes (B=32, f32; timed; K4 at "
        "(32,192,56,56): phase 3):")
    for name, shape, bias in (
            ("lrn_across_channels", (ZOO_B, 64, 56, 56), False),
            ("lrn_across_channels", (ZOO_B, 192, 56, 56), False),
            ("bias_relu_lrn_across_channels", (ZOO_B, 192, 56, 56), True)):
        check_lrn(K, torch, name, shape, torch.float32, False, bias, res)
        if not bias:
            check_lrn_bwd(K, torch, name + "_bwd", shape, torch.float32,
                          False, res)
    return dict(weights=weights, runs=runs, step_vs_plain=steps,
                fused_bias_lrn=fused)


def stats_moved(label, model):
    """Every BatchNorm's statistics in a trained .caffemodel: finite,
    count > 0, variance > 0 somewhere."""
    import numpy as np
    from caffeonspark_tpu_torch import checkpoint
    blobs = checkpoint.load_caffemodel_blobs(model)
    bns = [ln for ln in blobs if ln.startswith("bn_")]
    check(len(bns) == 53, f"{label}: {len(bns)} BatchNorm layers in {model}")
    for ln in bns:
        mean, var, count = blobs[ln]
        check(all(np.isfinite(b).all() for b in blobs[ln])
              and count[0] > 0 and var.max() > 0 and np.abs(mean).max() > 0,
              f"{label}: {ln} statistics did not move (count {count})")
    return dict(bn_layers=len(bns),
                count=float(blobs[bns[0]][2][0]),
                var_max=max(float(blobs[ln][1].max()) for ln in bns))


def test_vs_cpu(label, solver_path, model, card, outdir):
    """-test of `model` on the CPU through caffe_on_spark.main, the
    witness for the card's `card` test_result: loss within
    TEST_VS_CPU_RTOL, accuracy within one of VAL_RECORDS records."""
    import shutil
    from caffeonspark_tpu_torch import caffe_on_spark
    d = os.path.join(outdir, "cpu")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.monotonic()
    rc = caffe_on_spark.main(["-conf", solver_path, "-test", "-model",
                              model, "-output", d, "-device", "cpu"])
    wall_s = time.monotonic() - t0
    check(rc == 0, f"{label}: -test on the CPU returned {rc}")
    with open(os.path.join(d, "test_result")) as f:
        cpu = json.load(f)
    loss_rel = abs(card["loss"][0] - cpu["loss"][0]) / abs(cpu["loss"][0])
    acc_diff = abs(card["accuracy"][0] - cpu["accuracy"][0])
    check(math.isfinite(cpu["loss"][0]) and loss_rel <= TEST_VS_CPU_RTOL
          and acc_diff <= 1.0 / VAL_RECORDS + 1e-6,
          f"{label}: -test on the card {card} against the CPU's {cpu} "
          f"(loss rel {loss_rel:.3g}, tol {TEST_VS_CPU_RTOL})")
    log(f"  {label}: -test on the card {card}, on the CPU {cpu} in "
        f"{wall_s:.1f} s: loss rel {loss_rel:.3g} (tol {TEST_VS_CPU_RTOL})"
        f", accuracy {acc_diff:.3g} apart")
    return dict(cpu_result=cpu, loss_rel=loss_rel, accuracy_diff=acc_diff,
                cpu_wall_s=wall_s)


def resnet_phase(K, torch, workdir, lmdb, test_lmdb, device="cuda"):
    """ResNet-50 at B=ZOO_B, crop ZOO_CROP: TRAIN_ITERS steps through the
    CLI (no custom kernel on the path: BatchNorm, Scale and Eltwise are
    plain PyTorch, as they were XLA's), the running statistics finite
    and moved, the step against the all-plain step, -test of the trained
    model (its TEST net normalizes with the stored statistics) against
    the CPU's -test of the same model (`test_vs_cpu`), then the same for
    a model trained at lr 1e-4, whose statistics fit its weights, with
    its TEST loss in the first-loss band; mini_cluster f32 at COS_STEPS_PER_LOOP=1 and
    GRAPH_K (cuDNN deterministic; final models, statistics included,
    byte-equal) and 2 steps of -dtype mixed, whose BatchNorm input and
    statistics stay f32 and whose first loss is within
    MIXED_VS_F32_LOSS_RTOL of 2 f32 steps'."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.ops import layers as L
    solver, weights, n_bn = write_zoo_config(
        workdir, zoo.resnet50, lmdb, RESNET_SOLVER, seed=4,
        test_lmdb=test_lmdb)
    train, model = train_phase(
        K, "ResNet50 train", solver, {},
        os.path.join(workdir, "resnet50_out"), (), per_step=ZOO_B,
        device=device, first_loss=RESNET_FIRST_LOSS)
    stats = stats_moved("ResNet50 train", model)
    step, kept = step_vs_plain(K, torch, "ResNet50 train", solver, {},
                               device=device)
    step["direct_step_ms"] = zoo_direct_steps(torch, "ResNet50 train",
                                              solver, kept, device)
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    test = eval_phase(K, "ResNet50", solver, model,
                      os.path.join(workdir, "resnet50_test_out"), "test",
                      (), 0, device=device)
    test.update(test_vs_cpu("ResNet50", solver, model, test["test_result"],
                            os.path.join(workdir, "resnet50_test_out")))
    # a model whose statistics fit its weights: its TEST loss is a
    # classifier's (in the first-loss band), and the CPU's agrees
    fit_solver, _, _ = write_zoo_config(
        workdir, zoo.resnet50, lmdb, RESNET_FIT_SOLVER, seed=4,
        name="ResNet50Fit", test_lmdb=test_lmdb)
    fit_train, fit_model = train_phase(
        K, "ResNet50 lr 1e-4 train", fit_solver, {},
        os.path.join(workdir, "resnet50fit_out"), (), per_step=ZOO_B,
        device=device, first_loss=RESNET_FIRST_LOSS)
    fit_test = eval_phase(K, "ResNet50 lr 1e-4", fit_solver, fit_model,
                          os.path.join(workdir, "resnet50fit_test_out"),
                          "test", (), 0, device=device)
    fit_loss = fit_test["test_result"]["loss"][0]
    check(RESNET_FIRST_LOSS[0] <= fit_loss <= RESNET_FIRST_LOSS[1],
          f"ResNet50 lr 1e-4: -test loss {fit_loss:.4f} outside "
          f"{RESNET_FIRST_LOSS}: the statistics do not fit the weights")
    fit_test.update(test_vs_cpu(
        "ResNet50 lr 1e-4", fit_solver, fit_model, fit_test["test_result"],
        os.path.join(workdir, "resnet50fit_test_out")))
    fit_test["train_losses"] = fit_train["losses"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mc = {}
    try:
        for k in (1, GRAPH_K):
            mc[k] = mc_phase(K, f"ResNet50 mini_cluster float32 K={k}",
                             solver, "float32",
                             os.path.join(workdir, f"resnet50_mc_k{k}_out"),
                             (), 0, env={"COS_STEPS_PER_LOOP": str(k)},
                             display=GRAPH_K, device=device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    name = os.path.basename(mc[1]["final_model"])
    files_equal(f"ResNet50 K={GRAPH_K} against K=1",
                os.path.dirname(mc[1]["final_model"]),
                os.path.dirname(mc[GRAPH_K]["final_model"]),
                [name, "resnet50_train_iter_4.caffemodel",
                 "resnet50_train_iter_4.solverstate"])
    mc_stats = stats_moved("ResNet50 graphed", mc[GRAPH_K]["final_model"])
    mixed = mc_phase(K, "ResNet50 mini_cluster mixed", solver, "mixed",
                     os.path.join(workdir, "resnet50_mc_mixed_out"), (), 0,
                     iters=2, device=device, first_loss=RESNET_FIRST_LOSS)
    f32_first = mc_phase(K, "ResNet50 mini_cluster float32 2 steps", solver,
                         "float32",
                         os.path.join(workdir, "resnet50_mc_f32_out"), (), 0,
                         iters=2, device=device,
                         first_loss=RESNET_FIRST_LOSS)
    loss_vs_f32("ResNet50", mixed, f32_first)
    # the mixed net's BatchNorm layers: f32 input, params and output
    gc.collect()
    torch.cuda.empty_cache()
    msolver, host = make_solver(torch, solver, {}, dtype="mixed",
                                device=device)
    seen = []
    op = L.get_op("BatchNorm")
    real = op.apply

    def spy(ctx, lp, params, bottoms):
        tops = real(ctx, lp, params, bottoms)
        seen.append({str(t.dtype) for t in bottoms + params + tops})
        return tops

    op.apply = spy
    try:
        from caffeonspark_tpu_torch.data.queue_runner import to_device
        from caffeonspark_tpu_torch.mini_cluster import cast_inputs
        params, _ = msolver.init()
        msolver.loss_and_grads(params, cast_inputs(
            msolver.train_net, to_device(host, msolver.device)))
    finally:
        op.apply = real
    check(len(seen) == n_bn and all(s == {"torch.float32"} for s in seen),
          f"ResNet50 mixed: BatchNorm dtypes {seen[:3]}...")
    log(f"  ResNet50 mixed: {len(seen)} BatchNorm layers took f32 input and "
        "statistics and gave f32 output")
    del msolver, params, host
    return dict(weights=weights, bn_layers=n_bn, train=train, stats=stats,
                step_vs_plain=step, test=test, fit_test=fit_test,
                mc={f"k{k}": v for k, v in mc.items()},
                mc_graphed_stats=mc_stats, mc_equal_k1=True, mixed=mixed,
                f32_2_steps=f32_first, mixed_bn_f32=True)


def snapshot_phase(K, label, solver, outdir, kernels, launches_each,
                   per_step, unit, device="cuda", first_loss=(6.0, 8.0)):
    """The same TRAIN_ITERS-step run through the CLI synchronously and
    with -async_snapshot (cuDNN deterministic), snapshots at 4 and 8 (not
    after training too, which would write step 8 twice): every snapshot
    and the final model byte-equal; the wall time of each snapshot call
    on the solver thread, and the host interval of the step after each
    snapshot (it holds the snapshot) against the other steps'."""
    import torch
    with open(solver) as f:
        text = f.read()
    check("snapshot_after_train: true" in text, f"{solver}: no "
          "snapshot_after_train")
    solver = solver.replace("_solver.prototxt", "_snap_solver.prototxt")
    with open(solver, "w") as f:
        f.write(text.replace("snapshot_after_train: true",
                             "snapshot_after_train: false"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for key, args in (("sync", ()), ("async", ("-async_snapshot",))):
            with timed_snapshots() as calls:
                runs[key], _ = train_phase(
                    K, f"{label} {key}", solver, {}, f"{outdir}_{key}",
                    kernels, per_step=per_step, unit=unit,
                    launches_each=launches_each, args=args, device=device,
                    first_loss=first_loss)
            t = runs[key]["step_t"]
            iv = [1e3 * (t[i] - t[i - 1]) for i in range(1, len(t))]
            runs[key].update(
                snapshot_calls=calls,
                # t[i] is step i+1's dispatch: the snapshot after step 4
                # sits in t[4] - t[3]
                snapshot_interval_ms=iv[3],
                other_intervals_ms=[x for i, x in enumerate(iv)
                                    if i not in (0, 3)])
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    name = os.path.basename(solver).split("_")[0]
    names = [f"{name}_train_iter_{i}.{x}" for i in (4, TRAIN_ITERS)
             for x in ("caffemodel", "solverstate")] + ["model.caffemodel"]
    files_equal(f"{label} async against sync", f"{outdir}_sync",
                f"{outdir}_async", names)
    check(runs["sync"]["losses"] == runs["async"]["losses"],
          f"{label}: async losses differ from sync")
    nbytes = sum(os.path.getsize(os.path.join(f"{outdir}_sync", n))
                 for n in names[:2])
    for key, r in runs.items():
        c = r["snapshot_calls"]
        log(f"  {label} {key}: snapshot calls "
            + ", ".join(f"iter {x['iter']}{' (final)' if x['final'] else ''}"
                        f" {x['ms']:.1f} ms" for x in c)
            + f"; the interval holding the step-4 snapshot "
            f"{r['snapshot_interval_ms']:.1f} ms, other intervals median "
            f"{median(r['other_intervals_ms']):.1f} ms")
    log(f"  {label}: snapshot of {nbytes:,} bytes (model + state); async "
        "files byte-equal to sync")
    return dict(runs=runs, snapshot_bytes=nbytes, files_equal=names)


def hdf5_phase(K, torch, workdir, lmdb, kernels, device="cuda"):
    """CaffeNet (B=TRAIN_B) with snapshot_format HDF5 and BINARYPROTO
    (cuDNN deterministic): 2 steps with a snapshot at 2, then -snapshot
    from that state to 4; the two resumed final models equal.  Without
    h5py on this machine, the refusal of the HDF5 solver naming it,
    before any step."""
    import importlib.util
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark, checkpoint
    from caffeonspark_tpu_torch.models import zoo
    base = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                              suffix="H")
    with open(base) as f:
        text = f.read()
    solvers = {}
    for fmt in ("BINARYPROTO", "HDF5"):
        for n in (2, 4):
            lines = [ln for ln in text.splitlines()
                     if not ln.startswith(("max_iter:", "snapshot:"))]
            p = base.replace("_solver.prototxt", f"_{fmt}_{n}.prototxt")
            with open(p, "w") as f:
                f.write("\n".join(lines) + f"\nmax_iter: {n}\nsnapshot: 2\n"
                        f"snapshot_format: {fmt}\n")
            solvers[fmt, n] = p
    have = importlib.util.find_spec("h5py") is not None
    if not have:
        K.reset_launch_counts()
        try:
            caffe_on_spark.main(["-conf", solvers["HDF5", 2], "-train",
                                 "-output", os.path.join(workdir, "h5_out"),
                                 "-device", device])
        except RuntimeError as e:
            check("h5py" in str(e), f"HDF5 refusal does not name h5py: {e}")
            check(sum(K.launch_counts.values()) == 0,
                  "HDF5 refusal came after a step")
            log(f"  HDF5: h5py is missing on this machine; refused by "
                f"name before any step: {e}")
            return dict(h5py=False, refused=str(e), launches={})
        check(False, "an HDF5 solver ran without h5py")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    finals, counts = {}, {}
    K.reset_launch_counts()
    t0 = time.monotonic()
    try:
        for fmt in ("BINARYPROTO", "HDF5"):
            ext = ".h5" if fmt == "HDF5" else ""
            out = os.path.join(workdir, f"caffenet_{fmt.lower()}_out")
            out2 = out + "_resumed"
            for d in (out, out2):
                shutil.rmtree(d, ignore_errors=True)
            check(caffe_on_spark.main(["-conf", solvers[fmt, 2], "-train",
                                       "-output", out, "-device", device])
                  == 0, f"HDF5 phase: {fmt} run")
            state = os.path.join(out, f"caffeneth_train_iter_2.solverstate"
                                      f"{ext}")
            check(os.path.exists(state) and os.path.exists(
                state.replace("solverstate", "caffemodel")),
                f"HDF5 phase: no {state} or its model")
            check(caffe_on_spark.main(["-conf", solvers[fmt, 4], "-train",
                                       "-snapshot", state, "-output", out2,
                                       "-device", device]) == 0,
                  f"HDF5 phase: {fmt} resume")
            check(os.path.exists(os.path.join(
                out2, f"caffeneth_train_iter_4.caffemodel{ext}")),
                f"HDF5 phase: no {fmt} snapshot at 4")
            finals[fmt] = checkpoint.load_caffemodel_blobs(
                os.path.join(out2, "model.caffemodel"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts = dict(K.launch_counts)
    for k in kernels:
        check(counts.get(k, 0) == 2 * 8, f"HDF5 phase: {k} launched "
              f"{counts.get(k, 0)} times, expected 16")
    a, b = finals["BINARYPROTO"], finals["HDF5"]
    check(a.keys() == b.keys() and all(
        np.array_equal(x, y) for ln in a for x, y in zip(a[ln], b[ln])),
        "HDF5 phase: the resumed final models differ")
    log(f"  HDF5: 2 steps + resume to 4 in HDF5 and in binaryproto "
        f"({time.monotonic() - t0:.1f} s): resumed final models equal; "
        f"launches {counts}")
    return dict(h5py=True, finals_equal=True, launches=counts)


def sidecar_phase(K, torch, solver_path, model, device="cuda"):
    """AlexNet served in int8 (COS_FUSE_BIAS_RELU_LRN=1,
    COS_SERVE_WEIGHT_DTYPE=int8): the registry's load of the f32 model
    (parse, quantization, drift gate) timed; `<model>.quant` exported;
    a second registry loads the sidecar (timed) into the same resident
    blobs; then the CLI's server restarts from the sidecar (counts zeroed
    before, read after: K5 on fc6-fc8, 3 launches a flush) with every
    row within ROWS_INT8_TOL of the plain path, and the rows of one
    batch through both registries equal."""
    from caffeonspark_tpu_torch import checkpoint
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.serving.registry import ModelRegistry
    env = {"COS_FUSE_BIAS_RELU_LRN": "1", "COS_SERVE_WEIGHT_DTYPE": "int8"}
    sidecar = model + checkpoint.QUANT_SIDECAR_SUFFIX
    if os.path.exists(sidecar):
        os.remove(sidecar)
    loads = {}
    regs = {}
    for key in ("f32_then_quantize", "sidecar"):
        with env_set(env):
            conf = Config(["-conf", solver_path, "-serve", "-model", model,
                           "-device", device])
            regs[key] = reg = ModelRegistry.from_conf(conf)
        sync = (torch.cuda.synchronize if device == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        mv = reg.load(model)
        sync()
        loads[key] = 1e3 * (time.perf_counter() - t0)
        check(mv.weight_dtype == "int8", f"sidecar phase: {key} load is "
              f"{mv.weight_dtype}")
        if key == "f32_then_quantize":
            reg.export_quant_sidecar(model)
            check(os.path.exists(sidecar), "no quant sidecar written")
    a, b = (regs[k].current() for k in ("f32_then_quantize", "sidecar"))
    check(all(torch.equal(a.params[ln][bn], b.params[ln][bn])
              for ln in a.params for bn in a.params[ln])
          and all(torch.equal(a.scales[ln][bn], b.scales[ln][bn])
                  for ln in a.scales for bn in a.scales[ln]),
          "sidecar phase: resident blobs differ from the quantized load")
    net = regs["sidecar"].net
    g = torch.Generator(device=device).manual_seed(5)
    batch = {n: (torch.rand(s, device=device, generator=g) * 255
                 if kind == "data" else torch.zeros(s, device=device))
             for n, s, kind in net.input_specs}
    rows = [regs[k].forward(("fc8",), weight_dtype="int8")(
        regs[k].current().params, regs[k].current().scales, batch)["fc8"]
        for k in regs]
    check(torch.equal(rows[0], rows[1]), "sidecar phase: rows differ")
    del regs, a, b, rows
    log(f"  AlexNet int8: load of the f32 model + quantization + drift gate "
        f"{loads['f32_then_quantize']:.1f} ms; load of the sidecar "
        f"{loads['sidecar']:.1f} ms ({os.path.getsize(sidecar):,} bytes); "
        "resident blobs and rows equal")
    K.reset_launch_counts()
    served = serve_phase(K, torch, solver_path, model, env, ROWS_INT8_TOL,
                         "AlexNet int8 from its quant sidecar",
                         sizes=(4, 4, B), device=device)
    counts = dict(K.launch_counts)
    check(counts["int8_matmul"] > 0, "sidecar phase: K5 never launched")
    return dict(load_ms=loads, sidecar_bytes=os.path.getsize(sidecar),
                served=served, launches=counts)


# ---------------------------------------------------------------------------
# phases 28-31: the recurrent family, the caption pipeline, the stateless
# layer types
# ---------------------------------------------------------------------------

# the zoo's lstm_lm at its defaults: lrcn_cos.prototxt's widths (vocab
# 8801, embedding and LSTM 1000, 20 steps, batch 32)
LSTM_LM = dict(vocab=8801, d_model=1000, seq=20, batch_size=32)
LSTM_ROWS = 256
LSTM_WORD_FORMS = 9000
# Caffe's examples/coco_caption/lrcn_solver.prototxt, max_iter 110,000
# cut to TRAIN_ITERS, snapshot at 4
LRCN_SOLVER = """net: "{net}"
base_lr: 0.01
lr_policy: "step"
gamma: 0.5
stepsize: 20000
momentum: 0.9
weight_decay: 0
clip_gradients: 10
max_iter: {max_iter}
snapshot: 4
snapshot_prefix: "{name}_train"
snapshot_after_train: true
random_seed: 1
"""
# ln 8801 = 9.08 per counted position (the captioner weighs its loss by
# its 20 steps, as lrcn_cos.prototxt's loss_weight does)
LSTM_FIRST_LOSS = (8.6, 9.6)
CAPTIONER_FIRST_LOSS = (20 * 8.6, 20 * 9.6)
# the card's f32 step against the CPU port's on the same params and
# batch (TF32 off): the GEMMs sum in other orders
LSTM_CPU_LOSS_RTOL = 1e-5
LSTM_CPU_GRAD_TOL = 1e-4
STEPPER_CPU_TOL = 1e-4     # first decode step's probabilities, of the max
CAPTION_IMAGES = 32
NEAR_TIE = 1e-4            # top-1 minus top-2 probability below: a near-tie
LAYER_TOP_TOL = 1e-5       # the layer phase, card against CPU, of the max
LAYER_GRAD_TOL = 1e-4
STOCHASTIC_FREQ_TOL = 5e-3  # ~10 standard deviations over 512k windows


def synthetic_captions(n, seed):
    """`n` seeded captions of 8-20 words drawn from LSTM_WORD_FORMS word
    forms with a Zipf-like frequency, so that Vocab.build keeps the
    frequent ones."""
    import numpy as np
    rng = np.random.RandomState(seed)
    forms = [f"w{i}" for i in range(LSTM_WORD_FORMS)]
    p = 1.0 / np.arange(1, LSTM_WORD_FORMS + 1)
    p /= p.sum()
    return [" ".join(forms[j] for j in rng.choice(
        LSTM_WORD_FORMS, rng.randint(8, 21), p=p)) for _ in range(n)]


def write_lstm_config(workdir: str):
    """LSTM_ROWS JSON rows built by the port's image_caption_to_embedding
    from seeded synthetic captions (the Vocab built to 8801 words), the
    zoo's lstm_lm on a DataFrameSource over them and LRCN's solver."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetState, Phase
    from caffeonspark_tpu_torch.tools import Vocab, image_caption_to_embedding
    from caffeonspark_tpu_torch.tools.conversions import write_rows
    t0 = time.monotonic()
    caps = synthetic_captions(LSTM_ROWS, seed=23)
    vocab = Vocab.build(caps, LSTM_LM["vocab"])
    check(len(vocab) <= LSTM_LM["vocab"], f"vocab of {len(vocab)} words")
    rows = os.path.join(workdir, "lstm_rows.json")
    write_rows(image_caption_to_embedding(
        [{"id": str(i), "caption": c} for i, c in enumerate(caps)], vocab,
        caption_length=LSTM_LM["seq"] - 1), rows)
    vocab.save(os.path.join(workdir, "lstm_vocab"))
    npm = zoo.lstm_lm(**LSTM_LM)
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.DataFrameSource"
    data.cos_data_param.source = rows
    data.cos_data_param.dataframe_format = "json"
    n_params = Net(npm, NetState(phase=Phase.TRAIN), device="meta"
                   ).num_params()
    name = npm.name.lower()
    net_path = os.path.join(workdir, f"{name}_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{name}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(LRCN_SOLVER.format(net=net_path, max_iter=TRAIN_ITERS,
                                   name=name))
    log(f"  wrote {rows}: {LSTM_ROWS} caption rows ({len(vocab)} ids) in "
        f"{time.monotonic() - t0:.2f} s; {npm.name} {LSTM_LM}: "
        f"{n_params:,} parameters")
    return solver_path, vocab, n_params


def step_vs_cpu(torch, label, solver_path, loss_rtol, grad_tol,
                device="cuda"):
    """One solver step's loss and gradients on the card against the CPU
    port's on the same params (made on the card, copied) and batch."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.serving.forward import pin_f32_precision
    pin_f32_precision()
    card, host = make_solver(torch, solver_path, {}, device)
    cpu, _ = make_solver(torch, solver_path, {}, "cpu")
    params, _ = card.init()
    params_cpu = {ln: {bn: t.cpu() for bn, t in bl.items()}
                  for ln, bl in params.items()}
    loss_c, _, g_c = card.loss_and_grads(params, to_device(host, device))
    loss_h, _, g_h = cpu.loss_and_grads(params_cpu, to_device(host, "cpu"))
    lc, lh = float(loss_c), float(loss_h)
    rel = abs(lc - lh) / abs(lh)
    check(rel <= loss_rtol, f"{label}: loss {lc} on the card, {lh} on the "
          f"CPU (rel {rel:.3g}, tol {loss_rtol:.3g})")
    worst, at = _grad_diff(label, g_h, {ln: {bn: g.cpu() for bn, g in
                                             bl.items()}
                                        for ln, bl in g_c.items()},
                           grad_tol, "on the card against the CPU")
    log(f"  {label}: loss {lc:.6f} on the card, {lh:.6f} on the CPU (rel "
        f"{rel:.3g}); worst gradient {worst:.3g} of max |grad| at {at} "
        f"(tol {grad_tol})")
    return dict(label=label, loss_card=lc, loss_cpu=lh, loss_rel=rel,
                loss_rtol=loss_rtol, worst_grad_rel=worst,
                worst_grad_at=at, grad_tol=grad_tol)


def lstm_lm_phase(K, torch, workdir, device="cuda"):
    """(a) lstm_lm at lrcn_cos widths trained through the CLI under
    LRCN's solver (counts zeroed before, read after: no kernel), the
    card's first step against the CPU's; (b) mini_cluster in float32,
    mixed and bfloat16 (mixed and bfloat16's first loss against f32's),
    each again at COS_STEPS_PER_LOOP=GRAPH_K (final model byte-equal to
    K=1); per dtype 5 synchronized direct steps and 5 graphed chunks, one
    profiled step and one profiled chunk."""
    from caffeonspark_tpu_torch.mini_cluster import cast_inputs
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    solver_path, vocab, n_params = write_lstm_config(workdir)
    tokens = LSTM_LM["batch_size"] * LSTM_LM["seq"]
    train, _ = train_phase(
        K, "LSTMLM train", solver_path, {},
        os.path.join(workdir, "lstmlm_out"), (), device=device,
        per_step=tokens, unit="tokens", launches_each=0,
        first_loss=LSTM_FIRST_LOSS)
    log("one lstm_lm step on the card against the CPU port's:")
    vs_cpu = step_vs_cpu(torch, "LSTMLM train", solver_path,
                         LSTM_CPU_LOSS_RTOL, LSTM_CPU_GRAD_TOL, device)
    runs, graphed, direct, chunks, profiles = {}, {}, {}, {}, {}
    for dtype in ("float32", "mixed", "bfloat16"):
        runs[dtype] = mc_phase(
            K, f"LSTMLM mini_cluster {dtype}", solver_path, dtype,
            os.path.join(workdir, f"lstmlm_mc_{dtype}_out"), (), 0,
            device=device, first_loss=LSTM_FIRST_LOSS)
    for dtype in ("mixed", "bfloat16"):
        loss_vs_f32("LSTMLM", runs[dtype], runs["float32"])
    for dtype in ("float32", "mixed", "bfloat16"):
        run = mc_phase(
            K, f"LSTMLM mini_cluster {dtype} K={GRAPH_K}", solver_path,
            dtype, os.path.join(workdir, f"lstmlm_mc_{dtype}_k_out"), (), 0,
            device=device, env={"COS_STEPS_PER_LOOP": str(GRAPH_K)},
            display=GRAPH_K)
        check(run.get("chunks") == TRAIN_ITERS // GRAPH_K,
              f"{run['label']}: {run.get('chunks')} chunks")
        with open(run["final_model"], "rb") as a, \
                open(runs[dtype]["final_model"], "rb") as b:
            run["final_model_equal_k1"] = a.read() == b.read()
        check(run["final_model_equal_k1"], f"{run['label']}: the final "
              "model differs from the K=1 run's")
        graphed[dtype] = run
        gc.collect()
        solver, host = make_solver(torch, solver_path, {}, device, dtype)
        params, state = solver.init()

        def step(p, st, inputs, solver=solver):
            return solver.train_step(p, st, cast_inputs(solver.train_net,
                                                        inputs))

        direct[dtype] = direct_steps(torch, solver, params, state, host,
                                     step=step)
        prof_step = profile_train_step(
            torch, f"LSTMLM {dtype}", solver, params, state, host,
            what=f"one B={LSTM_LM['batch_size']} T={LSTM_LM['seq']} "
                 f"{dtype} lstm_lm step", step=step)
        many = solver.train_step_many(GRAPH_K)
        block = chunk_block(torch, host, GRAPH_K, device)

        def chunk(p, st, inputs, many=many, net=solver.train_net):
            return many(p, st, cast_inputs(net, inputs))

        for _ in range(2):        # the eager warm-up, the capture
            chunk(params, state, block)
        ms = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            chunk(params, state, block)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        if device == "cuda":
            check(many.captures == 1 and many.replays == 6,
                  f"graphed lstm_lm {dtype} chunks: {many.captures} "
                  f"captures, {many.replays} replays")
        chunks[dtype] = dict(chunk_ms=ms, step_ms=median(ms) / GRAPH_K)
        prof_chunk = profile_train_step(
            torch, f"LSTMLM {dtype} K={GRAPH_K}", solver, params, state,
            {k: v.cpu().numpy() for k, v in block.items()},
            what=f"one graphed chunk of {GRAPH_K} {dtype} lstm_lm steps",
            step=chunk)
        profiles[dtype] = dict(step=prof_step, chunk=prof_chunk)
        log(f"  LSTMLM {dtype}: 5 direct synchronized steps "
            + ", ".join(f"{x:.2f}" for x in direct[dtype])
            + f" ms (median {median(direct[dtype]):.2f}); graphed K="
            f"{GRAPH_K}: chunks " + ", ".join(f"{x:.2f}" for x in ms)
            + f" ms ({chunks[dtype]['step_ms']:.2f} ms a step)")
        del solver, params, state, host, block, many, chunk, step
    return dict(params=n_params, train=train, step_vs_cpu=vs_cpu,
                runs=runs, graphed=graphed, direct_step_ms=direct,
                direct_step_median_ms={k: median(v)
                                       for k, v in direct.items()},
                chunks=chunks, profiles=profiles), vocab


def captioner_text(batch, t_steps, feat, vocab_n, width, deploy=False):
    """tests/test_lrcn.py's captioner at the given widths: Embed, an LSTM
    with the image features as its static input, the per-step
    classifier; the loss weighted by the T steps (lrcn_cos.prototxt), or
    for `deploy` the Softmax `probs` in its place."""
    uni = 'weight_filler { type: "uniform" min: -0.08 max: 0.08 }'
    text = f"""name: "LRCNCaptioner"
layer {{ name: "data" type: "CoSData"
  top: "image_features" top: "cont_sentence" top: "input_sentence"
  top: "target_sentence"
  cos_data_param {{ batch_size: {batch}
    top {{ name: "image_features" type: FLOAT_ARRAY channels: {feat}
          sample_num_axes: 1 }}
    top {{ name: "cont_sentence" type: INT_ARRAY channels: {t_steps}
          sample_num_axes: 1 transpose: true }}
    top {{ name: "input_sentence" type: INT_ARRAY channels: {t_steps}
          sample_num_axes: 1 transpose: true }}
    top {{ name: "target_sentence" type: INT_ARRAY channels: {t_steps}
          sample_num_axes: 1 transpose: true }} }} }}
layer {{ name: "embedding" type: "Embed" bottom: "input_sentence"
  top: "embedded_input_sentence"
  embed_param {{ input_dim: {vocab_n} num_output: {width} bias_term: false
    {uni} }} }}
layer {{ name: "lstm1" type: "LSTM" bottom: "embedded_input_sentence"
  bottom: "cont_sentence" bottom: "image_features" top: "lstm1"
  recurrent_param {{ num_output: {width} {uni}
    bias_filler {{ type: "constant" }} }} }}
layer {{ name: "predict" type: "InnerProduct" bottom: "lstm1"
  top: "predict" inner_product_param {{ num_output: {vocab_n} axis: 2
    {uni} }} }}
"""
    if deploy:
        return text + """layer { name: "probs" type: "Softmax"
  bottom: "predict" top: "probs" softmax_param { axis: 2 } }
"""
    return text + f"""layer {{ name: "cross_entropy_loss"
  type: "SoftmaxWithLoss" bottom: "predict" bottom: "target_sentence" top: "cross_entropy_loss"
  loss_weight: {t_steps}.0 loss_param {{ ignore_label: -1 }}
  softmax_param {{ axis: 2 }} }}
"""


def decode_margins(rows):
    """Per step (B,) top-1 minus top-2 probability."""
    import numpy as np
    return [np.diff(np.sort(r, axis=-1)[:, -2:], axis=-1)[:, 0]
            for r in rows]


def compare_decodes(a_ids, a_rows, b_ids, b_rows):
    """Greedy against incremental: for each image the tokens of both up
    to its END, equal wherever both steps' margins exceed NEAR_TIE; an
    image is compared whole unless a near-tie comes first (after which
    the two may rightly part).  Returns (captions compared whole,
    tokens compared, near-ties met)."""
    ma, mb = decode_margins(a_rows), decode_margins(b_rows)
    whole = tokens = ties = 0
    for i, (sa, sb) in enumerate(zip(a_ids, b_ids)):
        ta, tb = list(sa) + [0], list(sb) + [0]
        tie = False
        for t in range(max(len(ta), len(tb))):
            if t >= len(ma) or t >= len(mb):
                break                 # max_length reached without END
            if min(ma[t][i], mb[t][i]) <= NEAR_TIE:
                tie = True
                break
            check(t < len(ta) and t < len(tb) and ta[t] == tb[t],
                  f"image {i}: greedy {sa} and incremental {sb} part at "
                  f"step {t + 1} with margins {ma[t][i]:.3g}, "
                  f"{mb[t][i]:.3g}")
            tokens += 1
            if ta[t] == 0:
                break
        ties += tie
        whole += not tie
    return whole, tokens, ties


def caption_phase(K, torch, workdir, vocab, caffenet_model, device="cuda"):
    """(c) CaffeNet -features fc8 of CAPTION_IMAGES seeded 3x256x256
    records (counts zeroed before, read after: K1 on norm1 and norm2);
    the rows feed the LRCN captioner at lrcn_cos widths (vocab 8801,
    embedding and LSTM 1000, the 1000-wide fc8 as its static input),
    trained TRAIN_ITERS steps through the CLI; the images decoded with
    greedy_caption, incremental_greedy_caption and beam_caption (beam
    3), each timed; greedy against incremental away from near-ties; the
    stepper's first step on the card against the CPU port's."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark, checkpoint
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetParameter, NetState, Phase
    from caffeonspark_tpu_torch.tools import image_caption as ic
    from caffeonspark_tpu_torch.tools import image_caption_to_embedding
    from caffeonspark_tpu_torch.tools.conversions import write_rows
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    lmdb = write_train_data(workdir, "caption_lmdb", CAPTION_IMAGES,
                            seed=29)
    feat_solver = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                                     test_lmdb=lmdb, suffix="Caption")
    outdir = os.path.join(workdir, "caption_features_out")
    shutil.rmtree(outdir, ignore_errors=True)
    K.reset_launch_counts()
    t0 = time.monotonic()
    rc = caffe_on_spark.main(["-conf", feat_solver, "-features", "fc8",
                              "-model", caffenet_model, "-output", outdir,
                              "-device", device])
    feat_s = time.monotonic() - t0
    feat_launches = dict(K.launch_counts)
    check(rc == 0, f"caption features: -features returned {rc}")
    # norm1 and norm2 a batch (the plain versions on the CPU: no launch)
    k1 = 2 * math.ceil(CAPTION_IMAGES / VAL_B) if device == "cuda" else 0
    want = {k: (k1 if k == "lrn_across_channels" else 0)
            for k in feat_launches}
    check(feat_launches == want, f"caption features: launches "
          f"{feat_launches}, expected {want}")
    with open(os.path.join(outdir, "features.json")) as f:
        feat_rows = [json.loads(x) for x in f if x.strip()]
    feats = np.asarray([r["fc8"] for r in feat_rows], np.float32)
    check(feats.shape == (CAPTION_IMAGES, 1000) and np.isfinite(feats).all(),
          f"caption features: fc8 rows {feats.shape}")
    log(f"  -features fc8 of {CAPTION_IMAGES} images in {feat_s:.1f} s; "
        f"launches {feat_launches}")

    t_steps, width, vocab_n = LSTM_LM["seq"], LSTM_LM["d_model"], \
        LSTM_LM["vocab"]
    caps = synthetic_captions(CAPTION_IMAGES, seed=31)
    emb = image_caption_to_embedding(
        [{"id": r["SampleID"], "caption": c, "image_features": f}
         for r, c, f in zip(feat_rows, caps, feats.tolist())], vocab,
        caption_length=t_steps - 1)
    rows_path = os.path.join(workdir, "caption_rows.json")
    write_rows(emb, rows_path)
    npm = NetParameter.from_text(captioner_text(
        CAPTION_IMAGES, t_steps, 1000, vocab_n, width))
    data = npm.layer[0]
    data.source_class = "com.yahoo.ml.caffe.DataFrameSource"
    data.cos_data_param.source = rows_path
    data.cos_data_param.dataframe_format = "json"
    name = npm.name.lower()
    net_path = os.path.join(workdir, f"{name}_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{name}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(LRCN_SOLVER.format(net=net_path, max_iter=TRAIN_ITERS,
                                   name=name))
    train, model = train_phase(
        K, "LRCNCaptioner train", solver_path, {},
        os.path.join(workdir, "captioner_out"), (), device=device,
        per_step=CAPTION_IMAGES * t_steps, unit="tokens", launches_each=0,
        first_loss=CAPTIONER_FIRST_LOSS)
    # the step alone, without the CLI's feed (32 rows: every batch an
    # epoch of the DataFrameSource)
    solver, host = make_solver(torch, solver_path, {}, device)
    params, state = solver.init()
    train["direct_step_ms"] = direct_steps(torch, solver, params, state,
                                           host)
    log("  LRCNCaptioner: 5 direct synchronized steps "
        + ", ".join(f"{x:.2f}" for x in train["direct_step_ms"]) + " ms")
    del solver, params, state, host

    deploy_text = captioner_text(CAPTION_IMAGES, t_steps, 1000, vocab_n,
                                 width, deploy=True)
    deploy = Net(NetParameter.from_text(deploy_text),
                 NetState(phase=Phase.TEST), device=device)
    params = checkpoint.copy_layers(deploy, deploy.init(0), model,
                                    strict=True)
    extra = {"image_features": feats}
    K.reset_launch_counts()
    times, out = {}, {}
    for key in ("greedy", "incremental", "beam3"):
        rows = []
        sync()
        t0 = time.perf_counter()
        if key == "greedy":
            ids = ic.greedy_caption(deploy, params, feats,
                                    max_length=t_steps, step_probs=rows)
        elif key == "incremental":
            ids = ic.incremental_greedy_caption(
                NetParameter.from_text(deploy_text), params, extra,
                batch=CAPTION_IMAGES, max_length=t_steps, device=device,
                step_probs=rows)
        else:
            ids = ic.beam_caption(
                NetParameter.from_text(deploy_text), params, extra,
                batch=CAPTION_IMAGES, beam=3, max_length=t_steps,
                device=device)
        sync()
        times[key] = 1e3 * (time.perf_counter() - t0)
        check(len(ids) == CAPTION_IMAGES and all(
            0 < w < vocab_n for s in ids for w in s),
            f"{key} decode: ids {ids[:2]}...")
        out[key] = (ids, rows)
    decode_launches = dict(K.launch_counts)
    check(not any(decode_launches.values()),
          f"decode: launches {decode_launches}")
    whole, tokens, ties = compare_decodes(*out["greedy"],
                                          *out["incremental"])
    check(whole + ties == CAPTION_IMAGES, "greedy against incremental: "
          f"{whole} + {ties} of {CAPTION_IMAGES} images")
    log(f"  decode of {CAPTION_IMAGES} images (max_length {t_steps}): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
        + f"; greedy against incremental: {whole} captions compared whole, "
        f"{tokens} tokens, {ties} stopped at a near-tie (margin <= "
        f"{NEAR_TIE})")

    # the stepper's first step on the card against the CPU port's
    first = {}
    for dev in (device, "cpu"):
        p = {ln: {bn: t.to(dev) for bn, t in bl.items()}
             for ln, bl in params.items()}
        names, states, forward = ic._make_stepper(
            NetParameter.from_text(deploy_text), CAPTION_IMAGES, "probs",
            dev)
        probs, _ = forward(p, {
            **ic._step_inputs(np.zeros(CAPTION_IMAGES), 1, "input_sentence",
                              "cont_sentence", torch.device(dev)),
            "image_features": torch.from_numpy(feats).to(dev), **states})
        first[dev] = probs[0].double().cpu().numpy()
    err = float(np.abs(first[device] - first["cpu"]).max()
                / np.abs(first["cpu"]).max())
    check(err <= STEPPER_CPU_TOL, f"the stepper's first step on the card "
          f"differs from the CPU's by {err:.3g} of the max (tol "
          f"{STEPPER_CPU_TOL})")
    log(f"  the stepper's first step on the card against the CPU: {err:.3g} "
        f"of the max probability (tol {STEPPER_CPU_TOL})")
    texts = ic.captions_to_text(out["beam3"][0][:2], vocab)
    return dict(features=dict(wall_s=feat_s, launches=feat_launches,
                              rows=len(feat_rows)),
                train=train, decode_ms=times,
                decode_launches=decode_launches,
                greedy_vs_incremental=dict(
                    captions_compared_whole=whole, tokens_compared=tokens,
                    stopped_at_near_tie=ties, near_tie=NEAR_TIE),
                beam_equals_greedy=out["beam3"][0] == out["greedy"][0],
                stepper_vs_cpu=err, stepper_tol=STEPPER_CPU_TOL,
                sample_beam_captions=texts)


def _layer_input(name, *dims):
    return (f'layer {{ name: "{name}" type: "Input" top: "{name}" '
            f'input_param {{ shape {{ {" ".join(f"dim: {d}" for d in dims)}'
            ' } } }\n')


def _layer_case(typ, bottoms, extra="", tops=("y",)):
    bots = " ".join(f'bottom: "{b}"' for b in bottoms)
    tps = " ".join(f'top: "{t}"' for t in tops)
    return f'layer {{ name: "l" type: "{typ}" {bots} {tps} {extra} }}\n'


def layer_cases():
    """{case: (prototxt, input kinds)} of the layer phase at working
    widths: the activations and MVN at (32, 256, 28, 28), the losses at
    (256, 1000), FCN-32s's upsampling head (Long et al.: `upscore`
    Deconvolution num_output 21, kernel 64, stride 32, no bias, then the
    `score` Crop at offset 19 to a 500x500 image), SPP of pyramid 3 at
    (32, 256, 13, 13), STOCHASTIC pooling (TEST) at AlexNet's pool
    shape, and the shape ops."""
    act = (32, 256, 28, 28)
    g = 'filler { type: "gaussian" std: 0.5 }'

    def one(typ, extra="", shape=act):
        return _layer_input("x", *shape) + _layer_case(typ, ["x"], extra)

    def loss(typ, shapes, extra=""):
        names = ["a", "b", "c"][:len(shapes)]
        return ("".join(_layer_input(n, *s) for n, s in zip(names, shapes))
                + _layer_case(typ, names, extra))

    lw = (256, 1000)
    return {
        "PReLU": (one("PReLU", f"prelu_param {{ {g} }}"), {}),
        "ELU": (one("ELU", "elu_param { alpha: 0.5 }"), {}),
        "Sigmoid": (one("Sigmoid"), {}),
        "TanH": (one("TanH"), {}),
        "AbsVal": (one("AbsVal"), {}),
        "BNLL": (one("BNLL"), {}),
        "Power": (one("Power", "power_param { power: 2 scale: 0.5 "
                               "shift: 1 }"), {}),
        "Exp": (one("Exp", "exp_param { base: 2 scale: 0.7 }"), {}),
        "Log": (one("Log", "log_param { scale: 1.5 shift: 0.2 }"),
                {"x": "pos"}),
        "Threshold": (one("Threshold", "threshold_param { threshold: 0.3 }"),
                      {}),
        "MVN": (one("MVN"), {}),
        "Bias": (one("Bias", f"bias_param {{ {g} }}"), {}),
        "Parameter": ('layer { name: "l" type: "Parameter" top: "y" '
                      'parameter_param { shape { dim: 256 dim: 1000 } } }\n',
                      {}),
        "BatchReindex": (_layer_input("x", 256, 1000) + _layer_input("i", 512)
                         + _layer_case("BatchReindex", ["x", "i"]),
                         {"i": "idx256"}),
        "SPP": (one("SPP", "spp_param { pyramid_height: 3 }",
                    (32, 256, 13, 13)), {}),
        "Deconvolution+Crop": (
            _layer_input("score_fr", 1, 21, 16, 16)
            + _layer_input("data", 1, 3, 500, 500)
            + 'layer { name: "upscore" type: "Deconvolution" '
              'bottom: "score_fr" top: "upscore" convolution_param { '
              'num_output: 21 bias_term: false kernel_size: 64 stride: 32 '
              'weight_filler { type: "gaussian" std: 0.01 } } }\n'
            + 'layer { name: "score" type: "Crop" bottom: "upscore" '
              'bottom: "data" top: "score" crop_param { axis: 2 '
              'offset: 19 } }\n', {}),
        "Reshape": (one("Reshape", "reshape_param { shape { dim: 0 dim: -1 } "
                                   "}"), {}),
        "Slice": (_layer_input("x", *act)
                  + _layer_case("Slice", ["x"], "slice_param { axis: 1 "
                                "slice_point: 96 }", ("y0", "y1")), {}),
        "Tile": (one("Tile", "tile_param { axis: 1 tiles: 2 }",
                     (32, 256, 13, 13)), {}),
        "Reduction": (one("Reduction", "reduction_param { operation: SUMSQ "
                                       "axis: 1 coeff: 0.5 }"), {}),
        "Silence": (_layer_input("x", *act) + _layer_input("z", 64)
                    + 'layer { name: "s" type: "Silence" bottom: "z" }\n'
                    + _layer_case("TanH", ["x"]), {}),
        "ArgMax": (one("ArgMax", "argmax_param { axis: 1 top_k: 5 "
                                 "out_max_val: true }"), {}),
        "EuclideanLoss": (loss("EuclideanLoss", [lw, lw]), {}),
        "SigmoidCrossEntropyLoss": (loss("SigmoidCrossEntropyLoss",
                                         [lw, lw]), {"b": "unit"}),
        "ContrastiveLoss": (loss("ContrastiveLoss", [lw, lw, (256,)],
                                 "contrastive_loss_param { margin: 40 }"),
                            {"c": "pair"}),
        "HingeLoss": (loss("HingeLoss", [lw, (256,)],
                           "hinge_loss_param { norm: L2 }"),
                      {"b": "label"}),
        "MultinomialLogisticLoss": (loss("MultinomialLogisticLoss",
                                         [lw, (256,)]),
                                    {"a": "prob", "b": "label"}),
        "InfogainLoss": (loss("InfogainLoss", [lw, (256,), (1000, 1000)]),
                         {"a": "prob", "b": "label", "c": "pos"}),
        "Pooling STOCHASTIC": (one("Pooling", "pooling_param { pool: "
                                              "STOCHASTIC kernel_size: 3 "
                                              "stride: 2 }",
                                   (32, 96, 55, 55)), {"x": "pos"}),
    }


def _layer_draw(np, kind, shape, rng):
    if kind == "pos":
        return (rng.rand(*shape) * 2 + 0.1).astype(np.float32)
    if kind == "unit":
        return rng.rand(*shape).astype(np.float32)
    if kind == "pair":
        return rng.randint(0, 2, shape).astype(np.float32)
    if kind == "idx256":
        return rng.randint(0, 256, shape).astype(np.float32)
    if kind == "label":
        return rng.randint(0, 1000, shape).astype(np.float32)
    if kind == "prob":
        z = np.exp(rng.randn(*shape))
        return (z / z.sum(axis=-1, keepdims=True)).astype(np.float32)
    return (rng.randn(*shape) * 2 + 0.5).astype(np.float32)


def layer_phase(K, torch, device="cuda"):
    """Each new stateless layer type forward and backward on the card
    against the CPU port on the same params and inputs (counts zeroed
    before, read after: no kernel): tops within LAYER_TOP_TOL and the
    gradients of a weighted sum of the tops within LAYER_GRAD_TOL of
    their largest element; STOCHASTIC pooling's TRAIN draw on the card:
    each value of a [1, 3, 2, 4] window picked with frequency value / 10
    over 512k windows, within STOCHASTIC_FREQ_TOL."""
    import numpy as np
    from caffeonspark_tpu_torch import convert
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.ops import layers as L
    from caffeonspark_tpu_torch.proto import (LayerParameter, NetParameter,
                                              NetState, Phase)
    from caffeonspark_tpu_torch.serving.forward import pin_f32_precision
    pin_f32_precision()
    K.reset_launch_counts()
    res = {}
    for case, (text, kinds) in layer_cases().items():
        rng = np.random.RandomState(13)
        nets = {dev: Net(NetParameter.from_text(text),
                         NetState(phase=Phase.TEST), device=dev)
                for dev in (device, "cpu")}
        ref = nets["cpu"]
        inputs = {n: _layer_draw(np, kinds.get(n), s, rng)
                  for n, s, _ in ref.input_specs}
        arrays = {ln: {bn: (rng.randn(*s) * 0.5).astype(np.float32)
                       for bn, s, _ in specs}
                  for ln, specs in ref.param_layout.items()}
        weights = {t: np.asarray(rng.randn(*ref.blob_shapes[t]), np.float32)
                   for t in ref.output_blobs if t not in inputs}
        out = {}
        for dev, net in nets.items():
            tp = {ln: {bn: t.requires_grad_(True) for bn, t in bl.items()}
                  for ln, bl in convert.params_from_numpy(net,
                                                          arrays).items()}
            tx = {n: torch.from_numpy(a).to(dev).requires_grad_(True)
                  for n, a in inputs.items()}
            if dev != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs = net(tp, tx)
            total = sum(torch.sum(blobs[t] * torch.from_numpy(w).to(dev))
                        for t, w in weights.items())
            leaves = [t for bl in tp.values() for t in bl.values()] + list(
                tx.values())
            grads = (torch.autograd.grad(total, leaves, allow_unused=True)
                     if total.requires_grad else [None] * len(leaves))
            if dev != "cpu":
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            out[dev] = ({t: blobs[t].detach().double().cpu()
                         for t in weights},
                        [None if g is None else g.double().cpu()
                         for g in grads], ms)
        top_err = grad_err = 0.0
        for t in weights:
            want = out["cpu"][0][t]
            top_err = max(top_err, float((out[device][0][t] - want).abs()
                                         .max() / want.abs().max()))
        for g, want in zip(out[device][1], out["cpu"][1]):
            check((g is None) == (want is None), f"{case}: a gradient on "
                  "one device only")
            if want is not None and float(want.abs().max()) > 0:
                grad_err = max(grad_err, float((g - want).abs().max()
                                               / want.abs().max()))
        check(top_err <= LAYER_TOP_TOL, f"{case}: tops on the card differ "
              f"from the CPU's by {top_err:.3g} of the max")
        check(grad_err <= LAYER_GRAD_TOL, f"{case}: gradients on the card "
              f"differ from the CPU's by {grad_err:.3g} of the max")
        res[case] = dict(top_err=top_err, grad_err=grad_err,
                         card_ms=out[device][2], cpu_ms=out["cpu"][2],
                         shapes={n: list(s) for n, s, _ in ref.input_specs})
        log(f"  {case}: tops {top_err:.3g}, gradients {grad_err:.3g} of the "
            f"max against the CPU; forward + backward {out[device][2]:.2f} "
            f"ms on the card (first call), {out['cpu'][2]:.1f} ms on the CPU")
        del nets, out
    lp = LayerParameter.from_text(
        'name: "p" type: "Pooling" bottom: "x" top: "y" pooling_param { '
        'pool: STOCHASTIC kernel_size: 2 stride: 2 }')
    win = torch.tensor([[1.0, 3.0], [2.0, 4.0]], device=device)
    x = win.repeat(512, 1024).reshape(1, 1, 1024, 2048)
    g = torch.Generator(device=device).manual_seed(3)
    y = L.get_op("Pooling").apply(L.Ctx(train=True, generator=g,
                                        layer_name="p"), lp, [], [x])[0]
    picks = y.ravel()
    freq = {v: float((picks == v).float().mean()) for v in (1, 2, 3, 4)}
    check(float((picks > 0).float().mean()) == 1.0 and all(
        abs(f - v / 10) <= STOCHASTIC_FREQ_TOL for v, f in freq.items()),
        f"STOCHASTIC TRAIN on the card: pick frequencies {freq}")
    res["Pooling STOCHASTIC TRAIN"] = dict(windows=int(picks.numel()),
                                           frequencies=freq,
                                           tol=STOCHASTIC_FREQ_TOL)
    log(f"  STOCHASTIC TRAIN on the card: over {picks.numel():,} windows "
        f"[1, 3, 2, 4] picked with frequencies {freq} (tol "
        f"{STOCHASTIC_FREQ_TOL})")
    launches = dict(K.launch_counts)
    check(not any(launches.values()), f"layer phase: launches {launches}")
    return dict(cases=res, launches=launches)


# ---------------------------------------------------------------------------
# phase 31: the rest of the data path feeding CaffeNet
# ---------------------------------------------------------------------------

# CaffeNet's net name in every run whose final model is held byte for
# byte against the encoded-LMDB run of phase 20 (a .caffemodel carries it)
DP_NET = "CaffeNetEncoded"
DP_MEAN = " ".join(f"mean_value: {v:g}" for v in MEAN_VALUE)
DP_TRAIN_XF = f"transform_param {{ crop_size: 227 mirror: true {DP_MEAN} }}"
DP_TEST_XF = f"transform_param {{ crop_size: 227 {DP_MEAN} }}"
# Caffe's models/finetune_flickr_style: ImageData of B 50 (256 x 256, crop
# 227, mirror), fc8_flickr of 20 classes at lr_mult 10 / 20, its solver
# (base_lr 0.001, step 0.1 every 20,000, momentum 0.9, weight_decay 5e-4;
# max_iter 100,000 cut to 8, test_interval / test_iter as VAL_SOLVER)
FLICKR_B, FLICKR_CLASSES = 50, 20
FLICKR_SOLVER = ('base_lr: 0.001\nlr_policy: "step"\ngamma: 0.1\n'
                 'stepsize: 20000\nmomentum: 0.9\nweight_decay: 0.0005\n'
                 'max_iter: 8\nsnapshot: 4\nsnapshot_prefix: "dpflickr_train"'
                 '\nrandom_seed: 1\n' + VAL_SOLVER)
FLICKR_FIRST_LOSS = (2.0, 4.5)     # ln 20 = 3.00 (fc8_flickr's std 0.01)


def _dp_layer(text: str):
    from caffeonspark_tpu_torch.proto.caffe import LayerParameter
    return LayerParameter.from_text(text)


def write_datapath_config(workdir: str, key: str, train, test=None) -> str:
    """The zoo's full-width CaffeNet (named DP_NET) with `train` (and a
    TEST layer `test`, validating as VAL_SOLVER) as its data layers, and
    TRAIN_SOLVER cut to TRAIN_ITERS steps, seed 1 as the encoded run's;
    files `<key>_train_val.prototxt`, `<key>_train_solver.prototxt`."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.proto import NetStateRule, Phase
    npm = zoo.caffenet(batch_size=TRAIN_B)
    npm.name = DP_NET
    npm.layer[0] = train
    if test is not None:
        train.include.append(NetStateRule(phase=Phase.TRAIN))
        test.include.append(NetStateRule(phase=Phase.TEST))
        npm.layer.insert(1, test)
    net_path = os.path.join(workdir, f"{key}_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, f"{key}_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(TRAIN_SOLVER.format(
            net=net_path, max_iter=TRAIN_ITERS, snapshot=4, after="true",
            name=key, seed=1, extra=VAL_SOLVER if test is not None else ""))
    return solver_path


def write_flickr_config(workdir: str, image_list: str) -> str:
    """finetune_flickr_style's train_val on CaffeNet: ImageData at TRAIN
    and TEST over `image_list`, fc8 renamed fc8_flickr (20 outputs,
    lr_mult 10 / 20), and its solver cut to 8 steps."""
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.proto import NetStateRule, Phase
    npm = zoo.caffenet(batch_size=FLICKR_B, num_classes=FLICKR_CLASSES)
    npm.name = "FlickrStyleCaffeNet"
    layers = []
    for phase, xf in ((Phase.TRAIN, DP_TRAIN_XF), (Phase.TEST, DP_TEST_XF)):
        lp = _dp_layer(
            'name: "data" type: "ImageData" top: "data" top: "label" '
            f'{xf} image_data_param {{ source: "{image_list}" '
            f'batch_size: {FLICKR_B} new_height: 256 new_width: 256 }}')
        lp.include.append(NetStateRule(phase=phase))
        layers.append(lp)
    npm.layer[0:1] = layers
    for lp in npm.layer:
        if lp.name == "fc8":
            lp.name = "fc8_flickr"
            lp.top[0] = "fc8_flickr"
            lp.param[0].lr_mult, lp.param[1].lr_mult = 10.0, 20.0
        lp.bottom[:] = ["fc8_flickr" if b == "fc8" else b
                        for b in lp.bottom]
    net_path = os.path.join(workdir, "dpflickr_train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(npm.to_text())
    solver_path = os.path.join(workdir, "dpflickr_train_solver.prototxt")
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\n{FLICKR_SOLVER}')
    return solver_path


@contextlib.contextmanager
def initial_params():
    """The processor's params just after its _init_params (the -weights
    copy, before step 1), kept on the host."""
    from caffeonspark_tpu_torch.processor import CaffeProcessor
    real = CaffeProcessor._init_params
    got = {}

    def spy(self):
        first = self.params is None
        real(self)
        if first and not got:
            got.update({ln: {bn: t.detach().cpu().numpy().copy()
                             for bn, t in bl.items()}
                        for ln, bl in self.params.items()})

    CaffeProcessor._init_params = spy
    try:
        yield got
    finally:
        CaffeProcessor._init_params = real


def reader_rate(label: str, src) -> dict:
    """Records a second of `src.records()` alone on this thread (the read
    and the parse, no decode)."""
    t0 = time.perf_counter()
    n = sum(1 for _ in src.records())
    s = time.perf_counter() - t0
    log(f"  reader {label}: {n} records in {s:.3f} s "
        f"({n / s:.1f} records/s)")
    return dict(records=n, seconds=s, records_per_s=n / s)


def datapath_refusals(workdir: str) -> dict:
    """HDF5Data, an ImageDataFrame and binary2dataframe to .parquet:
    refused by name where h5py / pyarrow are missing, else run."""
    import importlib.util

    import numpy as np
    from caffeonspark_tpu_torch.data.source import get_source
    from caffeonspark_tpu_torch.tools import converters
    out = {}
    h5list = os.path.join(workdir, "dp_h5_list.txt")
    with open(h5list, "w") as f:
        f.write("dp.h5\n")
    h5 = _dp_layer('name: "d" type: "HDF5Data" top: "data" top: "label" '
                   f'hdf5_data_param {{ source: "{h5list}" batch_size: 2 }}')
    if importlib.util.find_spec("h5py") is None:
        try:
            list(get_source(h5).records())
            check(False, "HDF5Data read with no h5py")
        except ImportError as e:
            check("h5py" in str(e), f"HDF5Data refusal names no h5py: {e}")
            out["HDF5Data"] = str(e)
    else:
        import h5py
        with h5py.File(os.path.join(workdir, "dp.h5"), "w") as f:
            f["data"] = np.zeros((4, 3), np.float32)
            f["label"] = np.zeros(4, np.float32)
        out["HDF5Data"] = len(list(get_source(h5).records()))
    have_pa = importlib.util.find_spec("pyarrow") is not None
    idf = _dp_layer(
        'name: "d" type: "MemoryData" top: "data" top: "label" '
        'source_class: "com.yahoo.ml.caffe.ImageDataFrame" '
        f'memory_data_param {{ source: "{workdir}/dp_images.parquet" '
        'batch_size: 2 channels: 3 height: 256 width: 256 }')
    img_dir = os.path.join(workdir, "dp_refusal_images")
    os.makedirs(img_dir, exist_ok=True)
    with open(os.path.join(img_dir, "a.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff")
    parquet = os.path.join(workdir, "dp_images.parquet")
    for what, fn in (
            ("binary2dataframe .parquet", lambda: converters.main(
                ["binary2dataframe", "-imageRoot", img_dir, "-output",
                 parquet])),
            ("ImageDataFrame", lambda: list(get_source(idf).records()))):
        if have_pa:
            fn()
            out[what] = "ran (pyarrow present)"
            continue
        try:
            fn()
            check(False, f"{what} ran with no pyarrow")
        except ImportError as e:
            check("pyarrow" in str(e), f"{what} refusal names no pyarrow: "
                  f"{e}")
            out[what] = str(e)
    for k, v in out.items():
        log(f"  refusal {k}: {v}")
    return out


def datapath_phase(K, torch, workdir, ref, test_lmdb, kernels,
                   device="cuda"):
    """The same 512 JPEG Datums as phase 20's encoded LMDB (`ref`: its
    path, final model and first packed batch), in LMDB key order, fed to
    full-width CaffeNet through every other store, each run through the
    CLI with the counts zeroed before and read after:
      (a) written as image files and converted by the converters CLI's
          binary2sequence into a part directory: SeqImageDataSource,
          -train for TRAIN_ITERS steps with a TEST layer on a SequenceFile
          (lmdb2sequence of the 100 TEST records), then -test;
      (b) a LevelDB of the same Datums written by the port's
          LevelDBWriter with snappy blocks, read by a source-less Data
          layer with backend LEVELDB: -train;
      (c) an ImageData list of the image files (labels mod 20):
          finetune_flickr_style from (a)'s model with -weights (every
          layer but fc8_flickr copied, checked before step 1);
      (d) a JSON-lines DataFrame (binary2dataframe to .json, base64
          images) through a CoSData ENCODED_IMAGE top with its own
          transform_param, inline packing (COS_TRANSFORM_THREADS=0: the
          top's draws are taken in the pack): -train; its first packed
          batch against the CPU port's;
      (e) HDF5Data, ImageDataFrame and parquet output refused by name
          where h5py / pyarrow are missing.
    (a) and (b) run under cuDNN deterministic as the reference did: their
    first packed batches bit-equal and their final models byte-equal to
    the encoded LMDB run's.  Each reader alone in records a second; each
    CLI run's median step interval, pack p50 and wall beside the
    reference's."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark
    from caffeonspark_tpu_torch.data.leveldb_io import LevelDBWriter
    from caffeonspark_tpu_torch.data.lmdb_io import LmdbReader
    from caffeonspark_tpu_torch.data.source import get_source
    from caffeonspark_tpu_torch.proto.caffe import Datum
    from caffeonspark_tpu_torch.tools import converters
    res, runs = {}, {}
    t_phase = time.monotonic()
    with LmdbReader(ref["lmdb"]) as r:
        kv = list(r.items(None, None))
    datums = [Datum.from_binary(v) for _, v in kv]
    img_dir = os.path.join(workdir, "dp_images")
    shutil.rmtree(img_dir, ignore_errors=True)
    os.makedirs(img_dir)
    labels = os.path.join(workdir, "dp_labels.txt")
    flickr_list = os.path.join(workdir, "dp_flickr_list.txt")
    with open(labels, "w") as lf, open(flickr_list, "w") as fl:
        for (k, _), d in zip(kv, datums):
            name = k.decode() + ".jpg"
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(d.data)
            lf.write(f"{name} {d.label}\n")
            fl.write(f"{img_dir}/{name} {d.label % FLICKR_CLASSES}\n")

    def run(key, label, solver, env=None, **kw):
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            rec, model = train_phase(
                K, label, solver, env or {},
                os.path.join(workdir, f"{key}_out"), kernels,
                device=device, **kw)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        runs[key] = rec
        return rec, model

    def held_to_ref(key, rec, model):
        batch = rec.pop("batches")[0]
        same_batch = all(np.array_equal(batch[k], ref["batch"][k])
                         for k in ("data", "label"))
        check(same_batch, f"{key}: first packed batch differs from the "
              "encoded LMDB run's")
        with open(model, "rb") as f, open(ref["model"], "rb") as g:
            same = f.read() == g.read()
        check(same, f"{key}: final model differs from the encoded LMDB "
              "run's (same records, order and draws)")
        rec.update(first_batch_equal=True, model_byte_equal=True)

    # (a) SequenceFile through binary2sequence
    seq_dir = os.path.join(workdir, "dp_seq")
    shutil.rmtree(seq_dir, ignore_errors=True)
    t0 = time.monotonic()
    check(converters.main(["binary2sequence", "-imageRoot", img_dir,
                           "-labelFile", labels, "-output",
                           os.path.join(seq_dir, "part-00000")]) == 0,
          "binary2sequence failed")
    seq_test = os.path.join(workdir, "dp_test.seq")
    check(converters.main(["lmdb2sequence", "-lmdb", test_lmdb, "-output",
                           seq_test]) == 0, "lmdb2sequence failed")
    res["convert_seq_s"] = time.monotonic() - t0

    def seq_layer(xf, src, b):
        return _dp_layer(
            'name: "data" type: "MemoryData" top: "data" top: "label" '
            'source_class: "com.yahoo.ml.caffe.SeqImageDataSource" '
            f'{xf} memory_data_param {{ source: "{src}" batch_size: {b} '
            'channels: 3 height: 256 width: 256 }')

    train = seq_layer(DP_TRAIN_XF, seq_dir, TRAIN_B)
    test = seq_layer(DP_TEST_XF, seq_test, VAL_B)
    solver = write_datapath_config(workdir, "dpseq", train, test)
    val_lrn = 2 * TRAIN_ITERS + VAL_ROUNDS * VAL_ITER * 2
    rec, seq_model = run("dpseq", "CaffeNet SequenceFile train+validate",
                         solver, capture=1, rounds=VAL_ROUNDS,
                         expect={kernels[0]: val_lrn})
    held_to_ref("dpseq", rec, seq_model)
    K.reset_launch_counts()
    out = os.path.join(workdir, "dpseq_test_out")
    shutil.rmtree(out, ignore_errors=True)
    check(caffe_on_spark.main(["-conf", solver, "-test", "-model",
                               seq_model, "-output", out, "-device",
                               device]) == 0,
          "SequenceFile -test failed")
    counts = dict(K.launch_counts)
    n_test = 2 * math.ceil(VAL_RECORDS / VAL_B)
    check(counts == {k: (n_test if k == kernels[0] else 0) for k in counts},
          f"SequenceFile -test: launches {counts}")
    with open(os.path.join(out, "test_result")) as f:
        test_result = json.load(f)
    check(all(math.isfinite(v[0]) for v in test_result.values()),
          f"SequenceFile -test: {test_result}")
    runs["dpseq_test"] = dict(test_result=test_result, launches=counts)
    log(f"  SequenceFile -test over {VAL_RECORDS} records: {test_result}; "
        f"launches {counts}")

    # (b) LevelDB, snappy blocks
    ldb = os.path.join(workdir, "dp_leveldb")
    shutil.rmtree(ldb, ignore_errors=True)
    t0 = time.monotonic()
    LevelDBWriter(ldb, snappy=True).write(kv)
    res["leveldb_write_s"] = time.monotonic() - t0
    res["leveldb_bytes"] = sum(os.path.getsize(os.path.join(ldb, f))
                               for f in os.listdir(ldb))
    log(f"  wrote {ldb}: {len(kv)} Datums, snappy blocks, "
        f"{res['leveldb_bytes'] / 2**20:.1f} MiB in "
        f"{res['leveldb_write_s']:.1f} s")
    ldb_layer = _dp_layer(
        'name: "data" type: "Data" top: "data" top: "label" '
        f'{DP_TRAIN_XF} data_param {{ source: "{ldb}" batch_size: {TRAIN_B} '
        'backend: LEVELDB }')
    solver = write_datapath_config(workdir, "dpleveldb", ldb_layer)
    rec, model = run("dpleveldb", "CaffeNet LevelDB train", solver,
                     capture=1)
    held_to_ref("dpleveldb", rec, model)

    # (c) ImageData: finetune_flickr_style from (a)'s model
    solver = write_flickr_config(workdir, flickr_list)
    with initial_params() as init:
        rec, _ = run("dpflickr", "FlickrStyle ImageData finetune", solver,
                     per_step=FLICKR_B, rounds=VAL_ROUNDS,
                     expect={kernels[0]: val_lrn},
                     args=("-weights", seq_model),
                     first_loss=FLICKR_FIRST_LOSS)
    from caffeonspark_tpu_torch import checkpoint
    weights = checkpoint.load_caffemodel_blobs(seq_model)
    copied = sorted(ln for ln in init if ln in weights)
    check(copied == sorted(ln for ln in weights if ln != "fc8")
          and "fc8_flickr" in init and all(
              np.array_equal(init[ln][bn], w) for ln in copied
              for bn, w in zip(init[ln], weights[ln])),
          "flickr: the -weights layers were not copied before step 1 "
          f"(copied {copied})")
    rec["copied_layers"] = copied

    # (d) a JSON DataFrame of base64 images through CoSData
    frame = os.path.join(workdir, "dp_frame.json")
    check(converters.main(["binary2dataframe", "-imageRoot", img_dir,
                           "-labelFile", labels, "-output", frame]) == 0,
          "binary2dataframe .json failed")
    frame_layer = _dp_layer(
        'name: "data" type: "CoSData" top: "data" top: "label" '
        'source_class: "com.yahoo.ml.caffe.DataFrameSource" '
        f'cos_data_param {{ source: "{frame}" dataframe_format: "json" '
        f'batch_size: {TRAIN_B} top {{ name: "data" type: ENCODED_IMAGE '
        f'channels: 3 height: 256 width: 256 {DP_TRAIN_XF} }} '
        'top { name: "label" type: FLOAT sample_num_axes: 0 } }')
    solver = write_datapath_config(workdir, "dpframe", frame_layer)
    rec, _ = run("dpframe", "CaffeNet JSON DataFrame train", solver,
                 env={"COS_TRANSFORM_THREADS": "0"}, capture=1)
    batch = rec.pop("batches")[0]
    # the CLI's feed shuffles with the driver's source (seed 0) and the
    # processor's source (the solver's random_seed) packs and draws
    rows = []
    for row in get_source(frame_layer, phase_train=True).shuffled_records(0):
        rows.append(row)
        if len(rows) == TRAIN_B:
            break
    cpu = get_source(frame_layer, phase_train=True, seed=1).next_batch(rows)
    check(all(np.array_equal(np.asarray(batch[k]).reshape(cpu[k].shape),
                             cpu[k]) for k in ("data", "label")),
          "DataFrame: the first packed batch differs from the CPU port's")
    rec["first_batch_equals_cpu"] = True

    # (e) refusals where the machine lacks h5py / pyarrow
    res["refusals"] = datapath_refusals(workdir)

    log("  each reader alone (one thread, read + parse, no decode):")
    rates = {}
    for key, layer in (
            ("lmdb_encoded", _dp_layer(
                'name: "data" type: "Data" top: "data" top: "label" '
                f'data_param {{ source: "{ref["lmdb"]}" batch_size: 1 '
                'backend: LMDB }')),
            ("sequencefile", train), ("leveldb_snappy", ldb_layer),
            ("image_list", _dp_layer(
                'name: "data" type: "ImageData" top: "data" top: "label" '
                f'image_data_param {{ source: "{flickr_list}" batch_size: 1 '
                'new_height: 256 new_width: 256 }')),
            ("json_dataframe", frame_layer)):
        rates[key] = reader_rate(key, get_source(layer, phase_train=False))
        check(rates[key]["records"] == len(kv),
              f"reader {key}: {rates[key]['records']} records")
    res["readers"] = rates
    # 8 steps give no steady rate (the pool's window of batches packed
    # ahead, validation rounds and the snapshot at 4 fall inside them):
    # each run's median step interval, its pack p50 a batch and its wall
    keys = ("median_step_ms", "pack_ms_p50", "wall_s")
    res["cli"] = {"lmdb_encoded": {k: ref[k] for k in keys},
                  **{name: {k: r[k] for k in keys}
                     for name, r in runs.items() if "wall_s" in r}}
    res["runs"] = runs
    res["wall_s"] = time.monotonic() - t_phase
    log("  CLI runs (median step interval over steps 3-8 / pack p50 a "
        "batch / wall of the -train call): " + "; ".join(
            f"{name} {v['median_step_ms']:.1f} ms / {v['pack_ms_p50']:.1f} "
            f"ms / {v['wall_s']:.1f} s" for name, v in res["cli"].items())
        + f"; phase {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 32: dp and tp ranks sharing the card (ParallelSolver, ZeRO-1) and
# evaluation on a mesh
# ---------------------------------------------------------------------------

DP_MESHES = (1, 2, 4)      # CaffeNet's dp extents at the global B=256
DP_LOSS_RTOL = 1e-3        # dp N's losses against dp 1's
DP_GRAD_TOL = 1e-4         # reduced gradients: 2x dp 1's f64 distance + this
ZERO_LOSS_RTOL = 1e-5      # ZeRO-1 dp 4 against plain dp 4
DP_LM_ITERS = 3            # the LM's mesh runs through mini_cluster (no
                           # snapshot before step 4)
DP_DIRECT_STEPS = 5


def _f64_grads(K, torch, solver, params, batch, env):
    """The same first step in float64 with every kernel plain: the
    reference both dp 1's and dp N's f32 gradients are held against."""
    from caffeonspark_tpu_torch.solver import Solver
    with env_set(env):
        s64 = Solver(solver.param, solver.train_net.net_param,
                     device=solver.device, dtype=torch.float64)
    p64 = {ln: {bn: t.double() for bn, t in bl.items()}
           for ln, bl in params.items()}
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    s64.generator.manual_seed(99)
    with plain_kernels(K):
        loss, _, g = s64.loss_and_grads(p64, b64)
    return float(loss), g


def _f64_errs(g, g64):
    """Each blob's max |g - g64| / max |g64|."""
    return {(ln, bn): float((g[ln][bn].double() - r).abs().max()
                            / max(float(r.abs().max()), 1e-300))
            for ln, bl in g64.items() for bn, r in bl.items()}


def no_snapshots(solver_path: str) -> str:
    """The solver of a -train config rewritten to write no snapshot (the
    final model only): the card's disk counts every byte a run writes,
    and phase 32's runs need their losses and final models only."""
    with open(solver_path) as f:
        text = f.read()
    text = text.replace("snapshot: 4\n", "snapshot: 0\n").replace(
        "snapshot_after_train: true", "snapshot_after_train: false")
    check("snapshot: 0\n" in text and "after_train: false" in text,
          f"{solver_path}: no snapshot cadence to turn off")
    with open(solver_path, "w") as f:
        f.write(text)
    return solver_path


def _mesh_spec(dims) -> str:
    """The -mesh spelling of build_mesh kwargs ({"dp": 2, "sp": 2} ->
    "2,1,2")."""
    order = ("dp", "tp", "sp")
    last = max(i for i, ax in enumerate(order) if dims.get(ax, 1) > 1)
    return ",".join(str(dims.get(ax, 1)) for ax in order[:last + 1])


@contextlib.contextmanager
def _patched(module, name, fn):
    """`module.name` replaced by `fn` for the context's duration."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def planted_faults():
    """Faults a mesh's step must not hide, each a context that plants it:
    the gradient exchange of parallel/dp.py keeping rank 0's gradient
    and dropping the others'; the layers' joins of tp column blocks (and
    head blocks) taken in reverse order."""
    from caffeonspark_tpu_torch.ops import layers as L
    from caffeonspark_tpu_torch.parallel import dp as dp_mod
    real_gather = L.all_gather
    return {
        "rank 0's gradient only": lambda: _patched(
            dp_mod, "all_reduce", lambda ts, mesh, axis: [ts[0]] * len(ts)),
        "tp blocks joined in reverse": lambda: _patched(
            L, "all_gather", lambda ts, dim: real_gather(ts[::-1], dim))}


def dp_first_grads(K, torch, label, solver_path, env, meshes, device="cuda",
                   fault=False):
    """The first step's loss and reduced gradients of ParallelSolver on
    each mesh of `meshes` (build_mesh kwargs) against the single-device
    step (same params, batch and dropout seed, cuDNN deterministic),
    both held against the same step in float64 with every kernel plain:
    the mesh's loss within DP_LOSS_RTOL of dp 1's, and each of its
    gradients no farther from the float64 gradient than twice dp 1's
    distance plus DP_GRAD_TOL (of the float64 gradient's max; a change
    of the reductions' order moves f32 gradients whose sums cancel,
    conv1's and conv2's weights, by up to about 1e-2 of their max, at
    dp 1 as at dp N); then DP_DIRECT_STEPS synchronized direct steps at
    dp 1 and on each mesh.  `fault`: the first mesh's step again under
    each of `planted_faults`, which the same limit must reject."""
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    solver, host = make_solver(torch, solver_path, env, device)
    batch = to_device(host, solver.device)
    params, state = solver.init()
    loss_64, g_64 = _f64_grads(K, torch, solver, params, batch, env)
    solver.generator.manual_seed(99)
    loss_1, _, g_1 = solver.loss_and_grads(params, batch)
    e_1 = _f64_errs(g_1, g_64)
    del g_64
    rec = dict(label=label, loss_f64=loss_64, loss_dp1=float(loss_1),
               dp1_worst_grad_vs_f64=max(e_1.values()), dp={})
    step_ms = {"1": direct_steps(torch, solver, params, state, host,
                                 n=DP_DIRECT_STEPS)}

    def first_step(ps):
        p0, st0 = solver.init()
        solver.generator.manual_seed(99)
        loss_n, _, g_n = ps.loss_and_grads(ps.shard_params(p0), batch)
        _, g_64 = _f64_grads(K, torch, solver, p0, batch, env)
        e_n = _f64_errs(g_n, g_64)
        over = {k: e for k, e in e_n.items()
                if e > 2 * e_1[k] + DP_GRAD_TOL}
        return p0, st0, float(loss_n), g_n, e_n, over

    for dims in meshes:
        spec = _mesh_spec(dims)
        gc.collect()
        torch.cuda.empty_cache()
        n = math.prod(dims.values())
        ps = ParallelSolver(solver, build_mesh(
            devices=[solver.device] * n, **dims))
        p0, st0, loss_n, g_n, e_n, over = first_step(ps)
        rel = abs(loss_n - float(loss_1)) / abs(float(loss_1))
        check(rel <= DP_LOSS_RTOL, f"{label} -mesh {spec}: first loss "
              f"{loss_n} against dp 1's {float(loss_1)} (rel {rel:.3g})")
        for key, e in over.items():
            check(False, f"{label} -mesh {spec}: {key[0]}/{key[1]} gradient"
                  f" {e:.3g} of max from the float64 step, dp 1's "
                  f"{e_1[key]:.3g}")
        raw = {k: float((g_n[k[0]][k[1]] - g_1[k[0]][k[1]]).abs().max()
                        / max(float(g_1[k[0]][k[1]].abs().max()), 1e-30))
               for k in e_1}
        at = max(raw, key=raw.get)
        step_ms[spec] = direct_steps(torch, solver, p0, ps.shard_opt_state(
            st0), host, n=DP_DIRECT_STEPS, step=ps.train_step)
        rec["dp"][spec] = dict(
            loss=loss_n, loss_rel=rel, worst_grad_vs_f64=max(e_n.values()),
            worst_grad_vs_dp1=raw[at], worst_grad_vs_dp1_at="/".join(at))
        del p0, st0, g_n
        log(f"  {label} -mesh {spec}: first loss {loss_n:.6f} (rel "
            f"{rel:.3g} of dp 1's); gradients at most {max(e_n.values()):.3g}"
            f" of max from the float64 step (dp 1: {max(e_1.values()):.3g});"
            f" against dp 1's at most {raw[at]:.3g} ({'/'.join(at)})")
        for name, plant in (planted_faults().items()
                            if fault and dims is meshes[0] else ()):
            with plant():
                *_, f_over = first_step(ps)
            worst = max(f_over.items(), key=lambda kv: kv[1],
                        default=(("", ""), 0.0))
            check(len(f_over) > 0, f"{label} -mesh {spec}: the planted "
                  f"fault ({name}) passed the limit")
            rec["dp"][spec].setdefault("planted_faults", {})[name] = dict(
                blobs_over_limit=len(f_over), of=len(e_1),
                worst="/".join(worst[0]), worst_vs_f64=worst[1])
            log(f"  {label} -mesh {spec}, planted fault ({name}): "
                f"{len(f_over)} of {len(e_1)} blobs over the limit, worst "
                f"{'/'.join(worst[0])} {worst[1]:.3g} of max")
        del ps
    rec["direct_step_ms"] = step_ms
    rec["direct_step_median_ms"] = {k: median(v) for k, v in step_ms.items()}
    log(f"  {label}: {DP_DIRECT_STEPS} synchronized direct steps at the "
        "global batch, median ms by -mesh: "
        + ", ".join(f"{k} {median(v):.1f}" for k, v in step_ms.items()))
    return rec


def zero_state_bytes(torch, solver_path, dp, device="cuda"):
    """Optimizer-state bytes each rank holds under ZeRO-1 at `dp` against
    dp 1's, fc6's and fc7's momentum at a quarter (no step is taken)."""
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    from caffeonspark_tpu_torch.parallel.comm import Shards
    solver, _ = make_solver(torch, solver_path, {}, device)
    params, st = solver.init()
    ps = ParallelSolver(solver, build_mesh(dp=dp,
                                           devices=[solver.device] * dp),
                        zero_dp=True)
    zst = ps.shard_opt_state(st)
    one = sum(t.numel() * t.element_size() for tree in (st.history,
                                                         st.history2)
              for bl in tree.values() for t in bl.values())
    per_rank = ps.state_bytes(zst)
    for ln in ("fc6", "fc7"):
        h = zst.history[ln]["weight"]
        check(isinstance(h, Shards) and len(h) == dp and all(
            x.numel() * dp == params[ln]["weight"].numel() for x in h),
            f"ZeRO-1 dp {dp}: {ln}'s momentum is not cut into {dp} "
            "equal slices")
    res = dict(dp=dp, dp1_bytes=one, per_rank_bytes=per_rank,
               fc6_fc7_rank_fraction=1.0 / dp)
    log(f"  ZeRO-1 dp {dp}: optimizer state {per_rank[0]:,} bytes a rank "
        f"against {one:,} at dp 1 ({per_rank[0] / one:.3f}); fc6 and fc7 "
        f"at 1/{dp}")
    del solver, params, st, zst, ps
    return res


def dp_eval(K, torch, label, solver_path, model, outdir, mode, dp1_launches,
            device="cuda"):
    """-test or -features fc8 (`mode`) of `model` under -mesh 2 and
    without it (counts zeroed before each): K1 launched twice as often
    under dp 2, the means or rows within ROWS_F32_TOL of the max of dp
    1's."""
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import caffe_on_spark
    args = ["-test"] if mode == "test" else ["-features", "fc8"]
    out, counts = {}, {}
    for key, mesh in (("dp2", ["-mesh", "2"]), ("dp1", [])):
        d = os.path.join(outdir, key)
        shutil.rmtree(d, ignore_errors=True)
        K.reset_launch_counts()
        rc = caffe_on_spark.main(["-conf", solver_path, *args, "-model",
                                  model, "-output", d, "-device", device,
                                  *mesh])
        counts[key] = dict(K.launch_counts)
        check(rc == 0, f"{label} {key}: -{mode} returned {rc}")
        name = "test_result" if mode == "test" else "features.json"
        with open(os.path.join(d, name)) as f:
            out[key] = (json.load(f) if mode == "test"
                        else [json.loads(x) for x in f if x.strip()])
    for key, dp in (("dp1", 1), ("dp2", 2)):
        want = {k: (dp * dp1_launches if k == "lrn_across_channels" else 0)
                for k in counts[key]}
        check(counts[key] == want, f"{label} {key}: launches "
              f"{counts[key]}, expected {want}")
    if mode == "test":
        err = max(abs(out["dp2"][k][0] - out["dp1"][k][0])
                  / max(abs(out["dp1"][k][0]), 1e-30) for k in out["dp1"])
    else:
        check([r["SampleID"] for r in out["dp2"]]
              == [r["SampleID"] for r in out["dp1"]],
              f"{label}: -features rows out of order under -mesh 2")
        g = np.asarray([r["fc8"] for r in out["dp2"]], np.float64)
        r_ = np.asarray([r["fc8"] for r in out["dp1"]], np.float64)
        err = float(np.abs(g - r_).max() / np.abs(r_).max())
    check(err <= ROWS_F32_TOL, f"{label}: -{mode} under -mesh 2 differs from "
          f"dp 1's by {err:.3g} (tol {ROWS_F32_TOL})")
    log(f"  {label}: -{mode} under -mesh 2 within {err:.3g} of dp 1's (tol "
        f"{ROWS_F32_TOL}); launches {counts['dp2']}")
    return dict(label=label, mode=mode, rel_err=err, launches=counts["dp2"],
                launches_dp1=counts["dp1"])


def dp_refusals(solver_path, lm_solver, model, device="cuda"):
    """ep, pp and -serve -mesh refused by name before a step runs (no
    output directory made); and what mini_cluster's -cluster 2 -mesh 1,2
    now lays out, without a rendezvous: the global mesh, rank r holding
    tp rank r (phase 35 trains it)."""
    import shutil
    from caffeonspark_tpu_torch import caffe_on_spark, mini_cluster
    from caffeonspark_tpu_torch.parallel.mesh import mesh_dims, process_box
    out = {}
    args = mini_cluster.build_argparser().parse_args(
        ["-solver", lm_solver, "-cluster", "2", "-server", "127.0.0.1:1",
         "-mesh", "1,2"])
    dims = mesh_dims(mini_cluster.mesh_spec(args), 2)
    boxes = [process_box(dims, 2, r) for r in range(2)]
    check(dims == {"dp": 1, "tp": 2} and all(
        local["tp"] == 1 and offs["tp"] == r
        for r, (local, offs) in enumerate(boxes)),
        f"-cluster 2 -mesh 1,2: dims {dims}, boxes {boxes}")
    out["tp_across_processes"] = (f"global mesh {dims}: rank r holds tp "
                                  "rank r")
    for key, argv, match in (
            ("ep", ["-conf", lm_solver, "-train", "-mesh", "1,1,1,2"],
             "Queue 1 item 8"),
            ("pp", ["-conf", lm_solver, "-train", "-mesh", "pp=2"],
             "Queue 1 item 8"),
            ("serve_mesh", ["-conf", solver_path, "-serve", "-model", model,
                            "-mesh", "2"], "serving on a mesh")):
        d = os.path.join(os.path.dirname(model), f"refused_{key}")
        shutil.rmtree(d, ignore_errors=True)
        entry = (mini_cluster.main if argv[0] == "-solver"
                 else caffe_on_spark.main)
        try:
            entry([*argv, "-output", d, "-device", device])
            msg = None
        except ValueError as e:
            msg = str(e)
        check(msg is not None and match in msg and not os.path.exists(d),
              f"dp refusal {key}: {msg!r}, expected a ValueError naming "
              f"{match!r} before any output")
        out[key] = msg
    log("  refused by name, or laid out: " + "; ".join(
        f"{k}: {v}" for k, v in out.items()))
    return out


def dp_phase(K, torch, workdir, lmdb, test_lmdb, val_solver, val_model,
             lm_solver, lm_mixed, device="cuda"):
    """CaffeNet, AlexNet and the LM with dp and tp ranks sharing the card
    (ParallelSolver; counts zeroed before each run, read after), at the
    global batch, under cuDNN deterministic, writing no snapshot
    (`no_snapshots`):
      * CaffeNet -train -mesh 1 and 2 (the validating config: its
        validation rounds within ROWS_F32_TOL of the max of dp 1's) and
        -mesh 4 (the TEST batch of 50 does not divide over 4: the config
        without validation): K1 / K2 dp times dp 1's, every loss within
        DP_LOSS_RTOL of dp 1's; the first step's reduced gradients at dp
        2 and 4 against dp 1's and the float64 step's (dp_first_grads),
        and synchronized direct steps by dp;
      * AlexNet COS_FUSE_BIAS_RELU_LRN=1 at -mesh 1 and 2: the same for
        K3 / K4;
      * CaffeNet -mesh 4 under COS_ZERO=1: losses within ZERO_LOSS_RTOL
        of plain dp 4's, and the state bytes a rank;
      * CaffeNet -mesh 2 at COS_STEPS_PER_LOOP=GRAPH_K: losses and final
        model byte-equal to the eager dp 2 run's;
      * -test and -features fc8 of `val_model` under -mesh 2 (dp_eval);
      * the LM through mini_cluster -dtype mixed for DP_LM_ITERS steps
        at -mesh 2,2 (K6 / K7 / K8 4 times dp 1's a step; losses within
        LM_STEP_GRAD_TOL of the dp 1 mixed run's) and -mesh 2,1,2 (K9 and
        K7 / K8: the sp 2 ring once per dp row); the f32 LM's first-step
        reduced gradients at -mesh 2,2 and 2,1,2 against dp 1's and the
        float64 step's (dp_first_grads), with planted faults (the
        exchange dropping rank 1's gradient, tp blocks joined in reverse)
        that the limit rejects;
      * the refusals (dp_refusals)."""
    from caffeonspark_tpu_torch.models import zoo
    lrn = ("lrn_across_channels", "lrn_across_channels_bwd")
    fused = ("bias_relu_lrn_across_channels",
             "bias_relu_lrn_across_channels_bwd")
    plain_solver = no_snapshots(write_train_config(
        workdir, zoo.caffenet, lmdb, seed=1, suffix="Dp"))
    alex_solver = no_snapshots(write_train_config(
        workdir, zoo.alexnet, lmdb, seed=2, suffix="Dp"))
    dp_val_solver = no_snapshots(write_train_config(
        workdir, zoo.caffenet, lmdb, seed=1, test_lmdb=test_lmdb,
        suffix="Dp"))
    fuse = {"COS_FUSE_BIAS_RELU_LRN": "1"}
    val_lrn = 2 * TRAIN_ITERS + VAL_ROUNDS * VAL_ITER * 2
    runs, models = {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.monotonic()
    try:
        for key, solver, env, dp, kernels, rounds in (
                ("caffenet_dp1", dp_val_solver, {}, 1, lrn, VAL_ROUNDS),
                ("caffenet_dp2", dp_val_solver, {}, 2, lrn, VAL_ROUNDS),
                ("caffenet_dp2_k4", dp_val_solver,
                 {"COS_STEPS_PER_LOOP": str(GRAPH_K)}, 2, lrn, VAL_ROUNDS),
                ("caffenet_dp4", plain_solver, {}, 4, lrn, 0),
                ("caffenet_dp4_zero", plain_solver, {"COS_ZERO": "1"}, 4,
                 lrn, 0),
                ("alexnet_dp1", alex_solver, fuse, 1, fused, 0),
                ("alexnet_dp2", alex_solver, fuse, 2, fused, 0)):
            gc.collect()
            torch.cuda.empty_cache()
            expect = ({kernels[0]: dp * val_lrn} if rounds else None)
            runs[key], models[key] = train_phase(
                K, f"{key} -mesh {dp}", solver, env,
                os.path.join(workdir, f"{key}_out"), kernels,
                launches_each=dp * 2 * TRAIN_ITERS, args=("-mesh", str(dp)),
                expect=expect, rounds=rounds, device=device,
                snapshots=False)
            runs[key]["dp"] = dp
        grads = [dp_first_grads(K, torch, "CaffeNet", plain_solver, {},
                                ({"dp": 2}, {"dp": 4}), device),
                 dp_first_grads(K, torch, "AlexNet fused", alex_solver,
                                fuse, ({"dp": 2},), device)]
    finally:
        torch.backends.cudnn.deterministic = prev
    base = {"caffenet": runs["caffenet_dp1"]["losses"],
            "alexnet": runs["alexnet_dp1"]["losses"]}
    for key, r in runs.items():
        ref = base[key.split("_")[0]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
        r["loss_rel_to_dp1"] = rel
        check(rel <= DP_LOSS_RTOL, f"{key}: losses {r['losses']} against "
              f"dp 1's {ref} (worst rel {rel:.3g}, tol {DP_LOSS_RTOL})")
    z, p4 = runs["caffenet_dp4_zero"], runs["caffenet_dp4"]
    zrel = max(abs(a - b) / abs(b) for a, b in zip(z["losses"],
                                                     p4["losses"]))
    check(zrel <= ZERO_LOSS_RTOL, f"ZeRO-1 dp 4: losses against plain dp "
          f"4's differ by {zrel:.3g} (tol {ZERO_LOSS_RTOL})")
    g, e = runs["caffenet_dp2_k4"], runs["caffenet_dp2"]
    with open(models["caffenet_dp2_k4"], "rb") as f1, \
            open(models["caffenet_dp2"], "rb") as f2:
        same = f1.read() == f2.read()
    check(same and g["losses"] == e["losses"],
          f"COS_STEPS_PER_LOOP={GRAPH_K} dp 2: final model byte-equal "
          f"{same}, losses {g['losses']} against eager {e['losses']}")
    v1, v2 = (runs["caffenet_dp1"]["validation"],
              runs["caffenet_dp2"]["validation"])
    verr = 0.0
    for key in ("accuracy", "loss"):
        top = max(max(abs(r[key]) for r in v1), 1e-30)
        verr = max(verr, max(abs(a[key] - b[key]) for a, b in zip(v1, v2))
                   / top)
    check(verr <= ROWS_F32_TOL, f"validation under -mesh 2 {v2} against dp "
          f"1's {v1}: {verr:.3g} of the max (tol {ROWS_F32_TOL})")
    log(f"  CaffeNet: ZeRO-1 dp 4 losses within {zrel:.3g} of plain dp 4's;"
        f" K={GRAPH_K} graphs at dp 2 byte-equal to eager; validation "
        f"under -mesh 2 within {verr:.3g} of dp 1's")
    zero = zero_state_bytes(torch, plain_solver, 4, device)
    evals = [dp_eval(K, torch, f"CaffeNet {mode}", val_solver, val_model,
                     os.path.join(workdir, f"dp_eval_{mode}"), mode,
                     2 * math.ceil(VAL_RECORDS / VAL_B), device)
             for mode in ("test", "features")]
    gc.collect()
    torch.cuda.empty_cache()
    lm_kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    per_step_dp1 = lm_mixed["launches"]["flash_attention_fwd"] // TRAIN_ITERS
    lm_tp = mc_phase(K, "TransformerLM mini_cluster -mesh 2,2 mixed",
                     lm_solver, "mixed",
                     os.path.join(workdir, "transformerlm_mc_dp2tp2_out"),
                     lm_kernels, 4 * per_step_dp1 * DP_LM_ITERS,
                     args=("-mesh", "2,2"), iters=DP_LM_ITERS,
                     device=device)
    lrel = max(abs(a - b) / abs(b) for a, b in
               zip(lm_tp["losses"], lm_mixed["losses"]))
    check(lrel <= LM_STEP_GRAD_TOL, f"LM -mesh 2,2 mixed: losses "
          f"{lm_tp['losses']} against dp 1's {lm_mixed['losses']} (rel "
          f"{lrel:.3g}, tol {LM_STEP_GRAD_TOL})")
    lm_tp["loss_rel_to_dp1"] = lrel
    gc.collect()
    torch.cuda.empty_cache()
    hops = 2 * 3     # two dp rows, each an sp 2 causal ring of 3 hops
    lm_sp = mc_phase(K, "TransformerLM mini_cluster -mesh 2,1,2 mixed",
                     lm_solver, "mixed",
                     os.path.join(workdir, "transformerlm_mc_dp2sp2_out"),
                     ("flash_block_update", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"),
                     LM["layers"] * hops * DP_LM_ITERS,
                     args=("-mesh", "2,1,2"), iters=DP_LM_ITERS,
                     device=device)
    srel = max(abs(a - b) / abs(b) for a, b in
               zip(lm_sp["losses"], lm_mixed["losses"]))
    check(srel <= LM_STEP_GRAD_TOL, f"LM -mesh 2,1,2 mixed: losses "
          f"{lm_sp['losses']} against dp 1's (rel {srel:.3g})")
    lm_sp["loss_rel_to_dp1"] = srel
    log(f"  LM mixed: -mesh 2,2 losses within {lrel:.3g} and -mesh 2,1,2 "
        f"within {srel:.3g} of dp 1's (tol {LM_STEP_GRAD_TOL})")
    gc.collect()
    torch.cuda.empty_cache()
    grads.append(dp_first_grads(
        K, torch, "TransformerLM f32", lm_solver, {},
        ({"dp": 2, "tp": 2}, {"dp": 2, "sp": 2}), device, fault=True))
    refused = dp_refusals(val_solver, lm_solver, val_model, device)
    wall = time.monotonic() - t_phase
    log(f"  the dp phase: {wall:.1f} s")
    for r in runs.values():
        r.pop("step_t", None)
    return dict(runs=runs, first_step=grads, zero_state=zero,
                zero_loss_rel=zrel, graphed_byte_equal=same,
                validation_rel_err=verr, eval=evals, lm_dp2_tp2=lm_tp,
                lm_dp2_sp2=lm_sp, refused=refused, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 33: the gradient exchange of the dp ranks (COS_GRAD_SYNC)
# ---------------------------------------------------------------------------

GS_STEPS = 8               # each configuration's steps (2 batches, cycled)
GS_DP = (2, 4)
GS_MODES = {               # the COS_GRAD_* knobs of each mode
    "default": {},
    "bucket": {"COS_GRAD_SYNC": "bucket"},
    "hier": {"COS_GRAD_SYNC": "hier"},
    "quant": {"COS_GRAD_SYNC": "quant"},
    "quant_int8": {"COS_GRAD_SYNC": "quant", "COS_GRAD_WIRE_DTYPE": "int8"}}
# quant's 8 losses against default's (worst rel) and the final params'
# L2 distance from default's over default's own update's L2 norm (both
# over the whole net).  Each limit sits between the readings of a sound
# run (H100, dp 2 / 4: bf16 losses 4.2e-6 / 4.8e-6, params 0.0021 /
# 0.0025; int8 3.1e-5 / 2.6e-5, 0.041 / 0.041) and those of the planted
# fault of `gs_frozen_fault`, which the phase checks they reject.
GS_LOSS_RTOL = {"quant": 1e-4, "quant_int8": 2e-4}
GS_PARAM_TOL = {"quant": 0.01, "quant_int8": 0.2}
CAFFENET_F32_WIRE = 243_860_896   # 60,965,224 params x 4 bytes


def _flat_dist(a, b):
    """sqrt of the sum over blobs of |a - b|^2, in float64."""
    return math.sqrt(sum(float(((a[ln][bn].double() - b[ln][bn].double())
                                ** 2).sum()) for ln in b for bn in b[ln]))


def _params_equal(a, b):
    import torch
    return all(torch.equal(a[ln][bn], b[ln][bn]) for ln in b for bn in b[ln])


def gs_run(K, torch, label, solver_path, env, dims, hosts, kernels, *,
           zero=False, k=1, first=False, steps=GS_STEPS, device="cuda"):
    """`steps` steps of ParallelSolver on the mesh `dims` (build_mesh
    kwargs) under the knobs `env`, from the solver's seeded init, the
    dropout generator at 99, over `hosts` cycled, each synchronized
    (counts zeroed before, read after): losses, final params, launches
    of `kernels`, ms a step (the median of the last 5; with K > 1, the
    last chunk's over K: a replay), the plan; with `first`, the first
    step's reduced gradients (from the init params, dropout at 99)
    too."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.parallel import ParallelSolver, build_mesh
    from caffeonspark_tpu_torch.solver import Solver
    from caffeonspark_tpu_torch.parallel.mesh import process_group
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # `dims` is the global mesh; this process holds its share of it
    n = math.prod(dims.values()) // process_group()[0]
    with env_set(env):
        conf = Config(["-conf", solver_path, "-train", "-device", device])
        solver = Solver(conf.solverParameter, conf.netParam, device=device)
        ps = ParallelSolver(solver, build_mesh(
            devices=[solver.device] * n, **dims), zero_dp=zero)
    params, state = ps.init()
    rec = dict(label=label, dims=dims, env=env, zero=zero, k=k,
               comm=ps.grad_sync.plan.comm_info(ps.mesh.dp_blocks),
               skipped=len(ps.grad_sync.plan.skipped),
               hooks=ps.grad_sync.use_hooks(1))
    grads = None
    if first:
        solver.generator.manual_seed(99)
        _, _, grads = ps.loss_and_grads(params, to_device(hosts[0],
                                                          solver.device))
    solver.generator.manual_seed(99)
    sync = (torch.cuda.synchronize if device == "cuda" else (lambda: None))
    K.reset_launch_counts()
    losses, ms = [], []
    if k == 1:
        for i in range(steps):
            batch = to_device(hosts[i % len(hosts)], solver.device)
            sync()
            t0 = time.perf_counter()
            loss, _ = ps.train_step(params, state, batch)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
    else:
        many = ps.train_step_many(k)
        for i in range(0, steps, k):
            block = {name: torch.stack([
                to_device(hosts[(i + j) % len(hosts)], solver.device)[name]
                for j in range(k)]) for name in hosts[0]}
            sync()
            t0 = time.perf_counter()
            out, _ = many(params, state, block)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0) / k)
            losses.extend(float(x) for x in out)
    rec.update(losses=losses, step_ms=ms,
               median_step_ms=median(ms[-5:] if k == 1 else ms[-1:]),
               launches={name: K.launch_counts.get(name, 0)
                         for name in kernels})
    check(all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses} not finite")
    return rec, params, grads, (ps, state, hosts)


def gs_overlap(torch, ps, params, state, host):
    """One warm bucket step under torch.profiler (host events): the
    first bucket's reduction (the hook's backward, traced by a
    record_function) is issued before the last convolution backward
    (conv1's, the first layer: nothing is left behind it).  This reads
    the host's issue order: every rank runs on the one stream, so no
    reduction runs beside a kernel on the device."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from caffeonspark_tpu_torch.data.queue_runner import to_device
    from caffeonspark_tpu_torch.parallel import gradsync
    real = gradsync.GradSync._transform_bucket

    def traced(self, bucket, ranks, generator):
        with record_function(f"gradsync_bucket_{bucket.index}"):
            return real(self, bucket, ranks, generator)

    sync = (torch.cuda.synchronize if params["conv1"]["weight"].is_cuda
            else (lambda: None))
    with _patched(gradsync.GradSync, "_transform_bucket", traced):
        ps.train_step(params, state, to_device(host, ps.device))
        sync()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ps.train_step(params, state, to_device(host, ps.device))
            sync()
    ev = [(e.time_range.start, e.name) for e in prof.events()]
    buckets = sorted((t, name) for t, name in ev
                     if name.startswith("gradsync_bucket_"))
    convs = sorted(t for t, name in ev
                   if name == "aten::convolution_backward")
    check(buckets and convs, "overlap profile: no bucket reduction or no "
          f"convolution backward among {len(ev)} events")
    b0 = min(t for t, name in buckets if name == "gradsync_bucket_0")
    after = sum(1 for t in convs if t > b0)
    check(b0 < convs[-1], "the first bucket's reduction was issued after "
          "the last convolution backward: no overlap")
    rec = dict(bucket_order=[name for _, name in buckets],
               conv_backwards=len(convs), conv_backwards_after_bucket0=after,
               bucket0_before_last_conv_us=convs[-1] - b0)
    log(f"  overlap under hooks: buckets issued in order "
        f"{rec['bucket_order']}; bucket 0 issued {convs[-1] - b0:.0f} us "
        f"before the last convolution backward (conv1's); {after} of "
        f"{len(convs)} convolution backwards after it")
    return rec


def gradsync_phase(K, torch, workdir, lmdb, lm_solver, device="cuda"):
    """The gradient exchange (`parallel/gradsync.py`, COS_GRAD_SYNC)
    over the dp ranks sharing the card, under cuDNN deterministic, no
    snapshot (direct steps, the same params, batches and dropout seed in
    every run; counts zeroed before each):
      * CaffeNet at the global B 256, dp 2 and dp 4, under default,
        bucket, hier, quant (bf16 wire) and quant with an int8 wire,
        GS_STEPS steps each: each plan's comm_info (the f32 exchange
        243,860,896 bytes a rank); the first step's reduced gradients
        (bucket and hier byte-equal to default's, quant bf16 equal to
        default's rounded through bf16, int8 within one quantum of
        default's and on the bucket's grid); losses and final params
        (bucket and hier byte-equal to default's; quant within
        GS_LOSS_RTOL and GS_PARAM_TOL); K1 / K2 launches equal to
        default's; the median of 5 synchronized steps against default's;
        at dp 2, a planted fault (the exchange zeroed after the first
        step) which those limits must reject;
      * bucket at dp 4 under COS_ZERO=1: byte-equal to bucket at dp 4;
      * bucket, quant and quant int8 at dp 2 as CUDA graphs of
        GRAPH_K steps, 3 chunks (eager warm-up, capture and replay,
        replay): byte-equal to the eager run of the same mode;
      * one profiled bucket step at dp 2: the first bucket's reduction
        issued before conv1's backward (gs_overlap);
      * the f32 LM at -mesh 2,2 under default and bucket: its tp blocks
        skipped by the plan, losses and final params byte-equal, K6 /
        K7 / K8 launches equal."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.models import zoo
    lrn = ("lrn_across_channels", "lrn_across_channels_bwd")
    solver = no_snapshots(write_train_config(workdir, zoo.caffenet, lmdb,
                                             seed=1, suffix="Gs"))
    hosts = host_batches(Config(["-conf", solver, "-train", "-device",
                                 device]), 2)
    runs, first, timing = {}, {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.monotonic()
    try:
        for dp in GS_DP:
            ref = ref_grads = p0 = None
            for mode, env in GS_MODES.items():
                key = f"dp{dp}_{mode}"
                rec, params, grads, keep = gs_run(
                    K, torch, f"CaffeNet dp {dp} {mode}", solver, env,
                    {"dp": dp}, hosts, lrn, first=True, device=device)
                plan = keep[0].grad_sync.plan
                check(plan.total_bytes_grad == CAFFENET_F32_WIRE,
                      f"{key}: {plan.total_bytes_grad} gradient bytes "
                      f"exchanged, expected {CAFFENET_F32_WIRE}")
                if mode == "default":
                    ref, ref_grads, ref_rec = params, grads, rec
                    p0 = keep[0].init()[0]
                    rec["update_norm"] = _flat_dist(params, p0)
                else:
                    first[key] = gs_first_check(torch, key, mode, plan,
                                                grads, ref_grads)
                    gs_compare(key, mode, rec, params, ref_rec, ref)
                if (dp, mode) == (2, "bucket"):
                    rec["overlap"] = gs_overlap(torch, keep[0], params,
                                                keep[1], hosts[0])
                runs[key] = rec
                log(f"  {key}: comm {json.dumps(rec['comm'])}; hooks "
                    f"{rec['hooks']}; step {rec['median_step_ms']:.2f} ms "
                    f"(default {ref_rec['median_step_ms']:.2f}); launches "
                    f"{rec['launches']}")
                timing[key] = rec["median_step_ms"]
                del params, grads, keep
                if mode == "bucket" and dp == 4:
                    zrec, zp, _, zkeep = gs_run(
                        K, torch, "CaffeNet dp 4 bucket ZeRO-1", solver,
                        env, {"dp": 4}, hosts, lrn, zero=True,
                        device=device)
                    check(zkeep[0].zero_on and zrec["losses"] == ref_rec[
                        "losses"] and _params_equal(zp, ref),
                        "bucket dp 4 under COS_ZERO=1: not byte-equal to "
                        "default dp 4")
                    check(zrec["launches"] == ref_rec["launches"],
                          f"ZeRO-1 bucket dp 4: launches {zrec['launches']}"
                          f" against {ref_rec['launches']}")
                    runs["dp4_bucket_zero"] = zrec
                    timing["dp4_bucket_zero"] = zrec["median_step_ms"]
                    log(f"  dp4_bucket_zero: byte-equal to default dp 4; "
                        f"step {zrec['median_step_ms']:.2f} ms")
                    del zp, zkeep
                if (dp, mode) == (2, "quant_int8"):
                    runs["dp2_quant_int8_frozen_fault"] = gs_frozen_fault(
                        K, torch, solver, env, hosts, lrn, ref_rec, ref,
                        device)
            del ref, ref_grads, p0
        for mode in ("bucket", "quant", "quant_int8"):
            env = GS_MODES[mode]
            eager, ep, _, _ = gs_run(K, torch, f"CaffeNet dp 2 {mode}",
                                     solver, env, {"dp": 2}, hosts, lrn,
                                     steps=3 * GRAPH_K, device=device)
            graphed, gp, _, _ = gs_run(
                K, torch, f"CaffeNet dp 2 {mode} K={GRAPH_K}", solver, env,
                {"dp": 2}, hosts, lrn, k=GRAPH_K, steps=3 * GRAPH_K,
                device=device)
            same = _params_equal(gp, ep) and graphed["losses"] == \
                eager["losses"]
            check(same, f"{mode} dp 2 as graphs of {GRAPH_K}: losses "
                  f"{graphed['losses']} against eager {eager['losses']}, "
                  "or the final params differ")
            check(graphed["launches"] == eager["launches"],
                  f"{mode} dp 2 graphed: launches {graphed['launches']} "
                  f"against eager {eager['launches']}")
            key = f"dp2_{mode}_k{GRAPH_K}"
            runs[key] = graphed
            timing[key] = graphed["median_step_ms"]
            log(f"  {key}: byte-equal to eager; a replayed chunk "
                f"{graphed['median_step_ms']:.2f} ms a step (eager "
                f"{eager['median_step_ms']:.2f})")
            del ep, gp
        lm_kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")
        lm_hosts = host_batches(Config(["-conf", lm_solver, "-train",
                                        "-device", device]), 2)
        lm = {}
        for mode in ("default", "bucket"):
            rec, params, _, keep = gs_run(
                K, torch, f"TransformerLM f32 -mesh 2,2 {mode}", lm_solver,
                GS_MODES[mode], {"dp": 2, "tp": 2}, lm_hosts, lm_kernels,
                device=device)
            lm[mode] = (rec, params)
            runs[f"lm_dp2tp2_{mode}"] = rec
            timing[f"lm_dp2tp2_{mode}"] = rec["median_step_ms"]
            log(f"  lm_dp2tp2_{mode}: comm {json.dumps(rec['comm'])}; "
                f"{rec['skipped']} blobs skipped (tp blocks); step "
                f"{rec['median_step_ms']:.2f} ms; launches "
                f"{rec['launches']}")
            del keep
        (d, dparams), (b, bparams) = lm["default"], lm["bucket"]
        check(b["skipped"] > 0 and b["comm"]["skipped_blobs"] > 0,
              "LM -mesh 2,2 bucket: no tp block skipped by the plan")
        check(b["losses"] == d["losses"] and _params_equal(bparams, dparams),
              f"LM -mesh 2,2 bucket: losses {b['losses']} against default "
              f"{d['losses']}, or the final params differ")
        check(b["launches"] == d["launches"] and all(
            v > 0 for v in d["launches"].values()),
            f"LM -mesh 2,2: launches {b['launches']} against default "
            f"{d['launches']}")
        del lm, dparams, bparams
    finally:
        torch.backends.cudnn.deterministic = prev
    wall = time.monotonic() - t_phase
    log("  synchronized step ms by mode: " + ", ".join(
        f"{k} {v:.2f}" for k, v in timing.items()))
    log(f"  the gradient exchange phase: {wall:.1f} s")
    for r in runs.values():
        r.pop("step_ms", None)
    return dict(runs=runs, first_step=first, step_ms=timing, wall_s=wall)


def gs_first_check(torch, key, mode, plan, grads, ref):
    """The first step's reduced gradients of `mode` against default's
    (`ref`, the same sums): bucket and hier byte-equal; quant bf16 equal
    to default's rounded through bf16; int8 within one quantum (the
    bucket's max |g| / 127) of default's, on the bucket's grid."""
    worst = 0.0
    for bucket in plan.buckets:
        flat = torch.cat([ref[ln][bn].reshape(-1)
                          for ln, bn in bucket.entries])
        scale = float(flat.abs().max()) / 127.0
        for ln, bn in bucket.entries:
            g, r = grads[ln][bn], ref[ln][bn]
            if mode in ("bucket", "hier"):
                ok = torch.equal(g, r)
            elif mode == "quant":
                ok = torch.equal(g, r.to(torch.bfloat16).to(r.dtype))
            else:
                err = float((g - r).abs().max())
                q = g.double() / scale
                ok = (err <= scale * (1 + 1e-5) and float(
                    (q - q.round()).abs().max()) < 1e-3)
                worst = max(worst, err / scale)
            check(ok, f"{key}: first-step gradient of {ln}/{bn} is not "
                  f"default's {'rounded ' if 'quant' in mode else ''}sum")
    out = dict(buckets=plan.n_buckets, wire=plan.wire_dtype or "grad",
               held="byte-equal" if mode in ("bucket", "hier") else
               "bf16(default)" if mode == "quant" else "one quantum")
    if mode == "quant_int8":
        out["worst_err_of_quantum"] = worst
    return out


def _from_default(rec, params, ref_rec, ref):
    """The worst relative loss difference from default's run, and the
    final params' distance from default's over default's update; both
    recorded in `rec`."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                  ref_rec["losses"]))
    dist = _flat_dist(params, ref) / ref_rec["update_norm"]
    rec.update(loss_rel_to_default=rel, param_dist_of_update=dist)
    return rel, dist


def gs_frozen_fault(K, torch, solver_path, env, hosts, kernels, ref_rec,
                    ref, device="cuda"):
    """The int8 run at dp 2 again with a planted fault: every exchanged
    gradient after the first step is zero (the update runs on momentum
    alone).  Both the loss and the param limit of every quant mode must
    reject it."""
    from caffeonspark_tpu_torch.parallel import gradsync
    real = gradsync.GradSync._transform_flat
    calls = [0]

    def zeroed(self, flats, generator):
        calls[0] += 1
        flat = real(self, flats, generator)
        return (flat if calls[0] <= self.plan.n_buckets
                else torch.zeros_like(flat))

    with _patched(gradsync.GradSync, "_transform_flat", zeroed):
        rec, params, _, _ = gs_run(K, torch, "CaffeNet dp 2 int8, the "
                                   "exchange zeroed after step 1",
                                   solver_path, env, {"dp": 2}, hosts,
                                   kernels, device=device)
    rel, dist = _from_default(rec, params, ref_rec, ref)
    check(calls[0] > 1, "planted fault: the exchange was never entered")
    for mode in GS_LOSS_RTOL:
        check(rel > GS_LOSS_RTOL[mode] and dist > GS_PARAM_TOL[mode],
              f"planted fault (exchange zeroed after step 1): losses "
              f"within {rel:.3g} of default's, params {dist:.3g} of its "
              f"update away, which the {mode} limits "
              f"({GS_LOSS_RTOL[mode]}, {GS_PARAM_TOL[mode]}) pass")
    log(f"  planted fault (int8 dp 2, the exchange zeroed after step 1): "
        f"losses {rel:.3g} of default's, params {dist:.3g} of its update "
        "away: rejected by every quant limit")
    return rec


def gs_compare(key, mode, rec, params, ref_rec, ref):
    """Losses, final params and launches of `mode` against default's."""
    check(rec["launches"] == ref_rec["launches"] and all(
        v > 0 for v in ref_rec["launches"].values()),
        f"{key}: launches {rec['launches']} against default's "
        f"{ref_rec['launches']}")
    if mode in ("bucket", "hier"):
        check(rec["losses"] == ref_rec["losses"] and
              _params_equal(params, ref),
              f"{key}: losses {rec['losses']} against default "
              f"{ref_rec['losses']}, or the final params differ")
        rec["byte_equal_to_default"] = True
        return
    rel, dist = _from_default(rec, params, ref_rec, ref)
    check(rel <= GS_LOSS_RTOL[mode] and dist <= GS_PARAM_TOL[mode],
          f"{key}: losses within {rel:.3g} of default's (tol "
          f"{GS_LOSS_RTOL[mode]}), params {dist:.3g} of default's update "
          f"from init (tol {GS_PARAM_TOL[mode]})")
    check(not _params_equal(params, ref), f"{key}: params equal default's:"
          " the wire rounded nothing")
    log(f"  {key}: losses within {rel:.3g} of default's, params "
        f"{dist:.3g} of default's update away")


# ---------------------------------------------------------------------------
# phase 34: data-parallel training across processes (gloo), two processes
# sharing the card
# ---------------------------------------------------------------------------

MP_SNAP = 4                # the ZeRO run's snapshot; the resumes start there
# dp 4 over two processes against one process's -mesh 4 (the four
# gradients associated otherwise): the final params' L2 distance over
# the -mesh 4 run's own update's L2 norm, over the whole net, the
# measure of GS_PARAM_TOL.  A sound run read 0.00116 on the H100 (losses
# 3.4e-6 apart); phase 33's bf16 wire reads 0.0021-0.0025 against its
# default run, its planted fault well above GS_PARAM_TOL's 0.01.  (A
# blob's largest difference over its largest weight read 0.0113, at a
# bias that had moved from zero by little.)
MP_PARAM_TOL = 5e-3
MP_CHILD_S = 600           # a pair of children's wait
MP_DIRECT_STEPS = 6        # 1 warm-up, then the median of the last 5
MP_STEP_MODES = {          # the direct steps' exchange configurations
    "default": {},
    "bucket": {"COS_GRAD_SYNC": "bucket"},
    "bucket_no_hooks": {"COS_GRAD_SYNC": "bucket", "COS_GRAD_OVERLAP": "0"},
    "hier": {"COS_GRAD_SYNC": "hier"},
    "hier_no_hooks": {"COS_GRAD_SYNC": "hier", "COS_GRAD_OVERLAP": "0"}}
MP_LRN = ("lrn_across_channels", "lrn_across_channels_bwd")


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mp_children(mode, specs, label, logdir, env=None):
    """`python3 chip_smoke.py --child <mode> <spec>` once per spec, all
    started together, their output to `logdir`: each one's result (the
    JSON after its `CHILD ` line) and output.  A child that fails ends
    the others and fails the phase; so does a wait past MP_CHILD_S."""
    os.makedirs(logdir, exist_ok=True)
    here = os.path.abspath(__file__)
    full_env = dict(os.environ, **(env or {}))
    paths = [os.path.join(logdir, f"{mode}_{i}.log")
             for i in range(len(specs))]
    files = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, here, "--child", mode,
                               json.dumps(spec)], stdout=f,
                              stderr=subprocess.STDOUT, env=full_env,
                              cwd=os.path.dirname(here))
             for spec, f in zip(specs, files)]
    deadline = time.monotonic() + MP_CHILD_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    out = []
    for i, (p, path) in enumerate(zip(procs, paths)):
        with open(path) as f:
            text = f.read()
        lines = [x for x in text.splitlines() if x.startswith("CHILD ")]
        check(p.returncode == 0 and lines, f"{label}: child {i} exited "
              f"{p.returncode} (a wait of {MP_CHILD_S} s):\n{text[-4000:]}")
        res = json.loads(lines[-1][len("CHILD "):])
        res["output"] = text
        out.append(res)
    return out


def mp_pair(K, label, solver_path, args, env, outdir, launches_each,
            device="cuda", outputs=None):
    """`mini_cluster -server 127.0.0.1:<free port> -cluster 2 -rank I` as
    two processes on the card, -metrics every step: each child's launch
    counts (each of MP_LRN `launches_each` times, no other kernel), both
    print every iter line and only rank 0 the final model; rank 0's
    losses and the model's path."""
    import shutil
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    port = _free_port()
    steps_path = os.path.join(outdir, "steps.jsonl")
    model = os.path.join(outdir, "final.caffemodel")
    t0 = time.monotonic()
    kids = mp_children("mini_cluster", [dict(argv=[
        "-solver", solver_path, "-output", outdir, "-model", model,
        "-metrics", steps_path, "-display_every", "1", "-device", device,
        "-server", f"127.0.0.1:{port}", "-cluster", "2", "-rank", str(r),
        *args]) for r in range(2)], label, os.path.join(outdir, "logs"),
        env)
    wall_s = time.monotonic() - t0
    with open(steps_path) as f:
        steps = [json.loads(x) for x in f if x.strip()]
    losses = [r["loss"] for r in steps]
    check(all(math.isfinite(x) for x in losses) and losses,
          f"{label}: losses {losses}")
    for r, kid in enumerate(kids):
        want = _want_launches(launches_each, kid["launches"], r)
        check(kid["launches"] == want, f"{label}: rank {r} launches "
              f"{kid['launches']}, expected {want}")
        last = steps[-1]["iter"]
        check(f"iter {last}/" in kid["output"]
              and ("final model →" in kid["output"]) == (r == 0),
              f"{label}: rank {r}'s output lacks its iter lines or shows "
              "another rank's final model line")
    check(os.path.exists(model), f"{label}: rank 0 wrote no {model}")
    if outputs is not None:
        outputs.extend(kid["output"] for kid in kids)
    log(f"  {label}: two processes, {len(losses)} steps in {wall_s:.1f} s; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; launches a "
        f"process {kids[0]['launches']}")
    return dict(label=label, wall_s=wall_s, losses=losses,
                launches=[k["launches"] for k in kids],
                split_bytes=[k.get("split_bytes") for k in kids],
                shapes=[k.get("shapes") for k in kids]), model


def _want_launches(launches_each, counts, rank=0):
    """The launch counts a run must show: `launches_each` of each MP_LRN
    kernel (an int), or the counts of a dict (of rank's dict, from a
    list), every other kernel 0."""
    if isinstance(launches_each, list):
        launches_each = launches_each[rank]
    if isinstance(launches_each, dict):
        return {k: launches_each.get(k, 0) for k in counts}
    return {k: (launches_each if k in MP_LRN else 0) for k in counts}


def split_blob_bytes(mc) -> dict:
    """A trained MiniCluster's bytes of the blobs a tp axis splits (its
    params', and its optimizer state's): this process's part of each."""
    ps = mc.psolver
    if ps is None:
        return {"params": 0, "state": 0}
    names = [(ln, bn) for ln, bl in ps.layout.param_specs.items()
             for bn, spec in bl.items() if "tp" in spec]

    def size(t):
        return t.numel() * t.element_size()
    st = mc.final_state
    return {"params": sum(size(mc.final_params[ln][bn]) for ln, bn in names),
            "state": sum(size(tree[ln][bn]) for tree in (st.history,
                                                         st.history2)
                         for ln, bn in names if tree.get(ln, {}).get(bn)
                         is not None)}


@contextlib.contextmanager
def flash_shapes(K, into):
    """Record the first operand's shape of each K6-K8 launch (the
    kernels' wrappers, spied on) into `into` {name: [shape, ...]}."""
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    real = {n: getattr(K, n) for n in names}

    def spy(n):
        def fn(*a, **kw):
            if a[0].device.type != "meta":
                shape = list(a[0].shape)
                if shape not in into.setdefault(n, []):
                    into[n].append(shape)
            return real[n](*a, **kw)
        return fn
    for n in names:
        setattr(K, n, spy(n))
    try:
        yield
    finally:
        for n in names:
            setattr(K, n, real[n])


def mp_one(K, label, solver_path, args, env, outdir, launches_each,
           device="cuda"):
    """`mini_cluster` in this process (one process, -mesh), counts zeroed
    before and read after; its final model is kept in memory, not
    written (the card's disk counts every byte): (record, the model's
    bytes, its params on the host)."""
    import shutil
    from caffeonspark_tpu_torch import checkpoint, mini_cluster
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    steps_path = os.path.join(outdir, "steps.jsonl")
    kept = {}

    def keep(path, net, params):
        kept["bytes"] = checkpoint.params_to_net_param(net,
                                                       params).to_binary()
        kept["params"] = {ln: {bn: t.detach().float().cpu().clone()
                               for bn, t in bl.items()}
                          for ln, bl in params.items()}

    K.reset_launch_counts()
    t0 = time.monotonic()
    shapes = {}
    with env_set(env), _patched(checkpoint, "save_model", keep), \
            flash_shapes(K, shapes):
        mc = mini_cluster.MiniCluster(mini_cluster.build_argparser(
        ).parse_args(["-solver", solver_path, "-output", outdir,
                      "-metrics", steps_path, "-display_every", "1",
                      "-device", device, *args]))
        mc.train()
    wall_s = time.monotonic() - t0
    counts = dict(K.launch_counts)
    check("bytes" in kept, f"{label}: mini_cluster wrote no final model")
    with open(steps_path) as f:
        losses = [json.loads(x)["loss"] for x in f if x.strip()]
    if launches_each is not None:
        want = _want_launches(launches_each, counts)
        check(counts == want, f"{label}: launches {counts}, expected "
              f"{want}")
    log(f"  {label}: one process, {len(losses)} steps in {wall_s:.1f} s; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; launches {counts}")
    rec = dict(label=label, wall_s=wall_s, losses=losses, launches=counts,
               split_bytes=split_blob_bytes(mc), shapes=shapes)
    del mc
    return rec, kept["bytes"], kept["params"]


@contextlib.contextmanager
def mp_paired_sums():
    """`comm.all_reduce` over 4 dp ranks in one process associated as
    two processes of two ranks associate it: each process sums its two
    ranks, gloo adds the two sums, (r0 + r1) + (r2 + r3) (rank order:
    ((r0 + r1) + r2) + r3).  Patched where the port calls it."""
    from caffeonspark_tpu_torch.ops import layers
    from caffeonspark_tpu_torch.parallel import comm, dp
    real = comm.all_reduce

    def paired(tensors, mesh, axis_name):
        if mesh is None or axis_name != "dp" or len(tensors) != 4:
            return real(tensors, mesh, axis_name)
        dev = tensors[0].device
        total = ((tensors[0] + tensors[1].to(dev))
                 + (tensors[2].to(dev) + tensors[3].to(dev)))
        return [total.to(d) for d in mesh.axis_devices(axis_name)]

    with _patched(comm, "all_reduce", paired), \
            _patched(dp, "all_reduce", paired), \
            _patched(layers, "all_reduce", paired):
        yield


def mp_init_params(solver_path):
    """The seeded initial params of a -train config's net, as float64
    numpy on the host (what `Solver.init` draws)."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.net import Net
    from caffeonspark_tpu_torch.proto import NetState, Phase
    conf = Config(["-conf", solver_path, "-train", "-device", "cpu"])
    seed = int(conf.solverParameter.random_seed)
    net = Net(conf.netParam, NetState(phase=Phase.TRAIN), device="cpu")
    return {ln: {bn: t.double().numpy() for bn, t in bl.items()}
            for ln, bl in net.init(seed if seed >= 0 else 1701).items()}


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def params_digest(params) -> str:
    """sha256 of the params' bytes, blob by blob in the net's order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for bl in params.values():
        for t in bl.values():
            h.update(t.detach().contiguous().cpu().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mp_collectives(torch, rank, device):
    """Each collective of `parallel.comm` over a dp axis spanning the two
    processes, on the device's tensors (2^20 floats seeded by rank),
    against its sum made here from both ranks' tensors: the route each
    took (`comm.ROUTES`) and whether its bits are the sum's."""
    from caffeonspark_tpu_torch.parallel import comm
    from caffeonspark_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(devices=[torch.device(device)])
    n = 1 << 20
    xs = [torch.randn(n, generator=torch.Generator().manual_seed(r)).to(
        device) for r in range(2)]
    total = xs[0] + xs[1]
    got = {
        "all_reduce": torch.equal(comm.all_reduce([xs[rank]], mesh,
                                                  "dp")[0], total),
        "reduce_scatter": torch.equal(comm.reduce_scatter(
            [xs[rank]], mesh, "dp")[0], total.chunk(2)[rank]),
        "all_gather": torch.equal(comm.all_gather_dp([xs[rank]], 0, mesh),
                                  torch.cat(xs)),
        "all_reduce_async": torch.equal(comm.start_reduce(
            [xs[rank]], mesh, hier=False)(), total),
        "hier_async": torch.equal(comm.start_reduce(
            [xs[rank]], mesh, hier=True)(), total)}
    return dict(equal=got, routes=dict(comm.ROUTES),
                tensor_device=xs[0].device.type)


def mp_steps_child(K, torch, spec):
    """A child of the timing pair: the collectives' check, then
    MP_DIRECT_STEPS synchronized ParallelSolver steps of this process's
    half of the global batch under each of MP_STEP_MODES (`gs_run` over
    a dp axis spanning the processes)."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.parallel.mesh import distributed_init
    _, rank = distributed_init(spec["server"], 2, spec["rank"])
    device = spec["device"]
    coll = mp_collectives(torch, rank, device)
    conf = Config(["-conf", spec["solver"], "-train", "-device", device])
    hosts = []
    for h in host_batches(conf, 2):
        half = len(next(iter(h.values()))) // 2
        hosts.append({k: v[rank * half:(rank + 1) * half]
                      for k, v in h.items()})
    recs = {}
    for key, env in MP_STEP_MODES.items():
        rec, params, _, _ = gs_run(K, torch, f"-cluster 2 {key}",
                                   spec["solver"], env, {"dp": 2}, hosts,
                                   MP_LRN, steps=MP_DIRECT_STEPS,
                                   device=device)
        recs[key] = {k: rec[k] for k in ("median_step_ms", "step_ms",
                                         "losses", "hooks", "comm",
                                         "launches")}
        recs[key]["digest"] = params_digest(params)
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    print("CHILD " + json.dumps({"collectives": coll, "steps": recs}),
          flush=True)
    return 0


def child_main(argv) -> int:
    """`chip_smoke.py --child <mode> <spec>`: one process of phase 34 or
    35, under cuDNN deterministic: `mini_cluster` (spec["argv"]; its
    launch counts, its bytes of the tp-split blobs, the K6-K8 shapes),
    `steps` (mp_steps_child), `mesh_steps` (mesh_steps_child) or
    `p2p_probe` (p2p_probe_child)."""
    import torch
    from caffeonspark_tpu_torch.ops import kernels as K
    from caffeonspark_tpu_torch.parallel.mesh import distributed_close
    mode, spec = argv[0], json.loads(argv[1])
    torch.backends.cudnn.deterministic = True
    rc = _child_mode(K, torch, mode, spec)
    distributed_close()         # in step: no peer still on the wire
    return rc


def _child_mode(K, torch, mode, spec) -> int:
    if mode == "mini_cluster":
        from caffeonspark_tpu_torch import mini_cluster
        K.reset_launch_counts()
        shapes = {}
        with flash_shapes(K, shapes):
            mc = mini_cluster.MiniCluster(
                mini_cluster.build_argparser().parse_args(spec["argv"]))
            mc.train()
        print("CHILD " + json.dumps({"rc": 0,
                                     "launches": dict(K.launch_counts),
                                     "split_bytes": split_blob_bytes(mc),
                                     "shapes": shapes}), flush=True)
        return 0
    if mode == "mesh_steps":
        return mesh_steps_child(K, torch, spec)
    if mode == "p2p_probe":
        return p2p_probe_child(torch, spec)
    check(mode == "steps", f"unknown child mode {mode!r}")
    return mp_steps_child(K, torch, spec)


def multiproc_phase(K, torch, workdir, lmdb, device="cuda"):
    """CaffeNet at the global B 256 trained by two processes sharing the
    card (`mini_cluster -server -cluster 2 -rank I`, gloo), each fed its
    block of 128 of every global batch, under cuDNN deterministic, with
    the counts zeroed before each run and read after (each process's
    K1 / K2 launches half of one-process -mesh 2's):
      * -cluster 2 under COS_GRAD_SYNC=hier: the final model byte-equal
        to one process's -mesh 2 (default: at dp 2 hier's reduce_scatter
        and all_gather give the same bits);
      * -cluster 2 under COS_ZERO=1 (default exchange) to step MP_SNAP,
        snapshotting there: rank 0's model and `.solverstate` (shape-
        only markers) and each rank's `.shard<k>` sidecar, read back
        whole; from it a resume to step 8 on two processes and one in
        one process (-mesh 2), both under COS_ZERO=1: byte-equal final
        models (the record stream and Dropout's generator restart at a
        resume, so neither equals an unbroken run); the files deleted;
      * -cluster 2 -devices 2 (dp 4, two ranks a process) against one
        process's -mesh 4: losses within DP_LOSS_RTOL, the params'
        distance within MP_PARAM_TOL of the update's norm; and byte-equal
        to one process's -mesh 4 whose sums are associated as the two
        processes associate them (`mp_paired_sums`);
      * a timing pair: each collective of `parallel.comm` across the
        processes on CUDA tensors against its sum, and the median of 5
        synchronized direct steps under default, bucket and hier with
        COS_GRAD_OVERLAP on and off, beside one process's dp 2 (default):
        each mode's losses and final params (sha256) byte-equal to it.
    The one-process runs keep their final models in memory (`mp_one`);
    the phase writes 6 CaffeNet-sized files."""
    import glob

    import numpy as np
    from caffeonspark_tpu_torch import checkpoint
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.models import zoo
    solver = no_snapshots(write_train_config(workdir, zoo.caffenet, lmdb,
                                             seed=1, suffix="Mp"))
    zsolver = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                                 suffix="MpZero")
    per_rank = 2 * TRAIN_ITERS
    zero = {"COS_ZERO": "1"}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.monotonic()
    runs = {}
    try:
        runs["mesh2"], m_mesh2, _ = mp_one(
            K, "CaffeNet -mesh 2", solver, ["-mesh", "2"], {},
            os.path.join(workdir, "mp_mesh2"), 2 * per_rank, device)
        runs["cluster2_hier"], m = mp_pair(
            K, "CaffeNet -cluster 2 hier", solver, [],
            {"COS_GRAD_SYNC": "hier"}, os.path.join(workdir, "mp_c2_hier"),
            per_rank, device)
        hier_equal = _file_bytes(m) == m_mesh2
        os.remove(m)
        check(hier_equal and runs["cluster2_hier"]["losses"]
              == runs["mesh2"]["losses"],
              "-cluster 2 hier: the final model is not byte-equal to one "
              "process's -mesh 2 (or the losses differ)")
        zdir = os.path.join(workdir, "mp_zero")
        runs["cluster2_zero_to4"], m = mp_pair(
            K, "CaffeNet -cluster 2 COS_ZERO=1 to 4", zsolver,
            ["-iterations", str(MP_SNAP)], zero, zdir,
            2 * MP_SNAP, device)
        name = os.path.basename(zsolver).split("_")[0]
        state = os.path.join(zdir, f"{name}_train_iter_{MP_SNAP}.solverstate")
        shards = sorted(os.path.basename(p)
                        for p in glob.glob(state + ".shard*"))
        check(shards == [os.path.basename(state) + f".shard{k}"
                         for k in range(2)],
              f"ZeRO-1 snapshot: sidecars {shards}")
        it, _, hist = checkpoint._read_state(state)
        check(it == MP_SNAP and all(np.isfinite(h).all() for h in hist),
              f"ZeRO-1 snapshot read back: iter {it}, finite "
              f"{[bool(np.isfinite(h).all()) for h in hist]}")
        sidecar_bytes = sum(os.path.getsize(os.path.join(zdir, s))
                            for s in shards)
        runs["cluster2_zero_resume"], m_resume = mp_pair(
            K, "CaffeNet -cluster 2 COS_ZERO=1 resume 4 -> 8", solver,
            ["-snapshot", state], zero, os.path.join(workdir, "mp_zero_r2"),
            2 * (TRAIN_ITERS - MP_SNAP), device)
        runs["mesh2_zero_resume"], m_r1, _ = mp_one(
            K, "CaffeNet -mesh 2 COS_ZERO=1 resume 4 -> 8", solver,
            ["-mesh", "2", "-snapshot", state], zero,
            os.path.join(workdir, "mp_zero_r1"),
            4 * (TRAIN_ITERS - MP_SNAP), device)
        resume_equal = _file_bytes(m_resume) == m_r1
        os.remove(m_resume)
        for p in glob.glob(os.path.join(zdir, "*_iter_*")):
            os.remove(p)
        check(resume_equal, "ZeRO-1 resume on two processes: the final "
              "model is not byte-equal to the same resume in one process")
        runs["mesh4"], _, p_mesh4 = mp_one(
            K, "CaffeNet -mesh 4", solver, ["-mesh", "4"], {},
            os.path.join(workdir, "mp_mesh4"), 4 * per_rank, device)
        runs["cluster2_devices2"], m = mp_pair(
            K, "CaffeNet -cluster 2 -devices 2", solver, ["-devices", "2"],
            {}, os.path.join(workdir, "mp_c2_d2"), 2 * per_rank, device)
        got = checkpoint.load_caffemodel_blobs(m)
        m_d2 = _file_bytes(m)
        os.remove(m)
        # the same dp 4 in one process with the ranks' gradients summed
        # as two processes of two ranks sum them: byte-equal
        with mp_paired_sums():
            runs["mesh4_paired"], m_paired, _ = mp_one(
                K, "CaffeNet -mesh 4, sums (r0 + r1) + (r2 + r3)", solver,
                ["-mesh", "4"], {}, os.path.join(workdir, "mp_mesh4p"),
                4 * per_rank, device)
        paired_equal = m_paired == m_d2
        check(paired_equal, "-cluster 2 -devices 2: the final model is not "
              "byte-equal to one process's -mesh 4 with its sums "
              "associated as the two processes associate them")
        init = mp_init_params(solver)
        sq = [0.0, 0.0]
        for ln, blobs in got.items():
            for g, bn in zip(blobs, p_mesh4[ln]):
                want = p_mesh4[ln][bn].numpy().astype(np.float64)
                sq[0] += float(((g - want) ** 2).sum())
                sq[1] += float(((want - init[ln][bn]) ** 2).sum())
        rel = math.sqrt(sq[0]) / math.sqrt(sq[1])
        lrel = max(abs(a - b) / abs(b) for a, b in zip(
            runs["cluster2_devices2"]["losses"], runs["mesh4"]["losses"]))
        check(lrel <= DP_LOSS_RTOL and rel <= MP_PARAM_TOL,
              f"-cluster 2 -devices 2 against -mesh 4: losses rel {lrel:.3g} "
              f"(tol {DP_LOSS_RTOL}), params {rel:.3g} of the update's L2 "
              f"norm (tol {MP_PARAM_TOL})")
        port = _free_port()
        timing = mp_children("steps", [dict(
            server=f"127.0.0.1:{port}", rank=r, solver=solver,
            device=device) for r in range(2)], "the timing pair",
            os.path.join(workdir, "mp_steps_logs"))
        coll = timing[0]["collectives"]
        check(all(all(t["collectives"]["equal"].values()) for t in timing),
              "collectives across processes: "
              f"{[t['collectives'] for t in timing]}")
        conf = Config(["-conf", solver, "-train", "-device", device])
        one, params, _, _ = gs_run(K, torch, "one process dp 2", solver, {},
                                   {"dp": 2}, host_batches(conf, 2), MP_LRN,
                                   steps=MP_DIRECT_STEPS, device=device)
        want = params_digest(params)
        del params
        # at dp 2 every mode's two-process steps train default's one-
        # process params bit for bit, on both ranks
        unequal = sorted({k for t in timing for k, v in t["steps"].items()
                          if v["digest"] != want
                          or v["losses"] != one["losses"]})
        check(not unequal, "synchronized steps at -cluster 2: the params "
              f"or losses under {unequal} are not byte-equal to one "
              "process's dp 2")
    finally:
        torch.backends.cudnn.deterministic = prev
    steps = {k: v for k, v in timing[0]["steps"].items()}
    log("  collectives across the two processes on "
        f"{coll['tensor_device']} tensors: " + ", ".join(
            f"{k}: {v}" for k, v in coll["routes"].items())
        + " (no staging of the port's own; each equal to its sum: "
        + ", ".join(f"{k} {v}" for k, v in coll["equal"].items()) + ")")
    log("  synchronized direct steps, median of 5 (ms): one process dp 2 "
        f"{one['median_step_ms']:.2f}; two processes " + ", ".join(
            f"{k} {v['median_step_ms']:.2f}" for k, v in steps.items())
        + f"; comm across processes a step (bytes): "
        f"{steps['default']['comm'].get('cross_process_bytes_per_step')}")
    wall = time.monotonic() - t_phase
    log(f"  the multi-process phase: {wall:.1f} s; sidecars of the ZeRO "
        f"snapshot {sidecar_bytes} bytes")
    return dict(runs=runs, hier_byte_equal=hier_equal,
                zero_resume_byte_equal=resume_equal,
                dp4_paired_byte_equal=paired_equal,
                dp4_loss_rel=lrel, dp4_param_rel=rel,
                collectives=coll, steps=steps,
                one_process_dp2_ms=one["median_step_ms"],
                one_process_dp2_step_ms=one["step_ms"],
                sidecar_bytes=sidecar_bytes, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 35: the tp and sp axes across processes, two processes sharing the
# card
# ---------------------------------------------------------------------------

MPM_LM_STEPS = 4            # the LM runs' steps (a) and (b)
MPM_VAL_TOL = 1e-4          # validation.json across processes against one
MPM_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
MPM_RING = ("flash_block_update", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")


MPM_PROBE_S = 90             # the send / recv probe's wait


def p2p_probe_child(torch, spec):
    """One process of the send / recv probe: one exchange of 2^20 floats
    on the device between the two processes through gloo's own send and
    recv, its bits checked (`CHILD` line), or the error gloo raised."""
    import torch.distributed as dist
    from caffeonspark_tpu_torch.parallel.mesh import distributed_init
    _, rank = distributed_init(spec["server"], 2, spec["rank"])
    x = torch.full((1 << 20,), float(rank + 1), device=spec["device"])
    buf = torch.empty_like(x)
    try:
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, buf, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        res = {"cuda_p2p": bool(torch.all(buf == float(2 - rank)))}
    except Exception as e:      # noqa: BLE001 - the probe's finding
        res = {"cuda_p2p": False, "error": f"{type(e).__name__}: {e}"[:300]}
    print("CHILD " + json.dumps(res), flush=True)
    return 0


def p2p_probe(device):
    """Whether gloo's send and recv take a CUDA tensor themselves (the
    port's `comm.shift_line` stages through pinned host buffers either
    way), in two throwaway processes: a crash or a hang (MPM_PROBE_S) is
    the finding, reported, never a failure of the phase."""
    port = _free_port()
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--child", "p2p_probe", json.dumps(dict(
            server=f"127.0.0.1:{port}", rank=r, device=device))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(here)) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=MPM_PROBE_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(killed: no answer in "
                        f"{MPM_PROBE_S} s)")
    lines = [x for x in outs[0].splitlines() if x.startswith("CHILD ")]
    if lines and procs[0].returncode == 0:
        return json.loads(lines[-1][len("CHILD "):])
    return {"cuda_p2p": False, "returncodes": [p.returncode for p in procs],
            "error": outs[0][-300:]}


def mesh_steps_child(K, torch, spec):
    """A child of phase 35's timing pair: MP_DIRECT_STEPS synchronized
    ParallelSolver steps of the LM on the global mesh spec["dims"]
    (this process holds its half), fed the global batches whole (a tp
    or sp mesh feeds every process the same records): the median, the
    losses, the params gathered whole (sha256) and the bytes each axis
    sent across processes a step."""
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.parallel import comm
    from caffeonspark_tpu_torch.parallel.mesh import distributed_init
    _, rank = distributed_init(spec["server"], 2, spec["rank"])
    device = spec["device"]
    conf = Config(["-conf", spec["solver"], "-train", "-device", device])
    comm.reset_traffic()
    rec, params, _, (ps, _, _) = gs_run(
        K, torch, f"-cluster 2 {spec['dims']}", spec["solver"], {},
        spec["dims"], host_batches(conf, 2), MPM_RING + MPM_FLASH[:1],
        steps=MP_DIRECT_STEPS, device=device)
    traffic = {k: v // MP_DIRECT_STEPS for k, v in comm.TRAFFIC.items()}
    digest = params_digest(ps.gather_params(params))
    print("CHILD " + json.dumps({
        "median_step_ms": rec["median_step_ms"],
        "step_ms": rec["step_ms"], "losses": rec["losses"],
        "launches": rec["launches"], "digest": digest,
        "bytes_per_step": traffic}), flush=True)
    return 0


def _half(counts, names):
    """Half of each of `names`' launches in `counts`, the rest 0: each of
    two processes' share of a tp run."""
    return [{k: (v // 2 if k in names else 0) for k, v in counts.items()}
            ] * 2


def _ring_shares(counts):
    """Each of two processes' share of an sp 2 causal ring's launches in
    `counts`: of the ring's three K9 hops sp rank 0 folds its diagonal,
    rank 1 its diagonal and rank 0's block (1 : 2); of its three K7 / K8
    pairs rank 0 runs its diagonal and rank 1's visiting q-group, rank 1
    its diagonal (2 : 1)."""
    return [{k: (v * (r + 1) // 3 if k == "flash_block_update"
                 else v * (2 - r) // 3 if k in MPM_RING else 0)
             for k, v in counts.items()} for r in range(2)]


def multiproc_mesh_phase(K, torch, workdir, lmdb, test_lmdb, lm_solver,
                         device="cuda"):
    """The tp and sp axes across two processes sharing the card
    (`mini_cluster -server -cluster 2 -rank I -mesh ...`, gloo; each
    process holds half of the global mesh), under cuDNN deterministic,
    counts zeroed before each run and read after, each against one
    process with the same -mesh (kept in memory, `mp_one`):
      (a) the full-width LM at -mesh 1,1,2 -dtype float32, 4 steps: the
          ring's hop across processes; losses and the final model
          byte-equal; the two processes' K9, K7 and K8 summing to one
          process's, each its sp rank's share of the causal ring
          (`_ring_shares`); the ppermute route;
      (b) the LM at -mesh 1,2, 4 steps: byte-equal; K6, K7 and K8 half,
          on (B·H/2, T, D) blocks; each process's bytes of the split
          blobs and of their Adam state half of one process's;
      (c) CaffeNet B 256 at -mesh 2,2 (dp in a process, fc6 / fc7
          columns across the two), 8 steps with a snapshot at 4: the
          final model byte-equal to one process's; rank 0's dense model
          and the `.shard0/.shard1` sidecars read back; a resume from 4
          to 8 on two processes and in one, byte-equal; files deleted;
      (d) the validating CaffeNet at -mesh 1,2: rank 0's validation.json
          within MPM_VAL_TOL of one process's, rank 1 writing none;
      (e) the timing pair: the median of 5 synchronized direct steps of
          the LM at -mesh 1,1,2 and 1,2 on two processes beside one
          process's (params by sha256 byte-equal to it), the gloo bytes
          a step of the ring's hops and of the tp joins, and whether
          gloo's own send / recv take CUDA tensors (`p2p_probe`)."""
    import glob
    import hashlib
    import shutil

    import numpy as np
    from caffeonspark_tpu_torch import checkpoint
    from caffeonspark_tpu_torch.config import Config
    from caffeonspark_tpu_torch.models import zoo
    from caffeonspark_tpu_torch.parallel import comm
    lm = os.path.join(workdir, "lm_mpm_solver.prototxt")
    shutil.copyfile(lm_solver, lm)
    lm = no_snapshots(lm)
    lm_args = ["-iterations", str(MPM_LM_STEPS), "-dtype", "float32"]
    csolver = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                                 suffix="Mpm")
    # the same net and solver without snapshots: only the pair's run
    # writes one (at 4, which the resumes read, and at 8)
    c_plain = os.path.join(workdir, "caffenet_mpm_plain_solver.prototxt")
    shutil.copyfile(csolver, c_plain)
    c_plain = no_snapshots(c_plain)
    vsolver = no_snapshots(write_train_config(
        workdir, zoo.caffenet, lmdb, seed=1, test_lmdb=test_lmdb,
        suffix="Mpm"))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.monotonic()
    runs, equal = {}, {}
    try:
        # (a) and (b): the LM on each mesh, one process, then two
        for key, spec, names, shares in (
                ("sp", "1,1,2", MPM_RING, _ring_shares),
                ("tp", "1,2", MPM_FLASH, lambda c: _half(c, MPM_FLASH))):
            one, m_one, _ = mp_one(
                K, f"LM -mesh {spec}", lm, ["-mesh", spec, *lm_args], {},
                os.path.join(workdir, f"mpm_{key}1"), None, device)
            check(all(one["launches"].get(n, 0) > 0 for n in names),
                  f"LM -mesh {spec}: launches {one['launches']}")
            two, m = mp_pair(
                K, f"LM -cluster 2 -mesh {spec}", lm,
                ["-mesh", spec, *lm_args], {},
                os.path.join(workdir, f"mpm_{key}2"),
                shares(one["launches"]), device)
            got = _file_bytes(m)
            os.remove(m)
            equal[key] = (got == m_one and two["losses"] == one["losses"])
            check(equal[key], f"LM -cluster 2 -mesh {spec}: the final model "
                  "(or the losses) not byte-equal to one process's")
            runs[f"lm_{key}_one"], runs[f"lm_{key}_two"] = one, two
            runs[f"lm_{key}_two"]["sha256"] = hashlib.sha256(got).hexdigest()
        tp1, tp2 = runs["lm_tp_one"], runs["lm_tp_two"]
        halves = all(2 * sb[k] == tp1["split_bytes"][k] > 0
                     for sb in tp2["split_bytes"] for k in ("params",
                                                            "state"))
        check(halves, f"LM -cluster 2 -mesh 1,2: each process's split blobs "
              f"{tp2['split_bytes']}, one process's {tp1['split_bytes']}")
        want_shape = [LM["batch"] * LM["heads"] // 2, LM["seq"],
                      LM["d_model"] // LM["heads"]]
        check(all(sh.get(n) == [want_shape] for sh in tp2["shapes"]
                  for n in MPM_FLASH),
              f"LM -cluster 2 -mesh 1,2: K6-K8 shapes {tp2['shapes']}, "
              f"expected {want_shape}")
        # (c) CaffeNet at -mesh 2,2: dp in a process, tp across the two
        one, m_one, _ = mp_one(
            K, "CaffeNet -mesh 2,2", c_plain, ["-mesh", "2,2"], {},
            os.path.join(workdir, "mpm_c1"), 4 * TRAIN_ITERS, device)
        cdir = os.path.join(workdir, "mpm_c2")
        runs["caffenet_one"] = one
        # each process runs both dp ranks' norms: as many as one process
        runs["caffenet_two"], m = mp_pair(
            K, "CaffeNet -cluster 2 -mesh 2,2", csolver, ["-mesh", "2,2"],
            {}, cdir, 4 * TRAIN_ITERS, device)
        equal["caffenet"] = _file_bytes(m) == m_one
        check(equal["caffenet"] and runs["caffenet_two"]["losses"]
              == one["losses"], "CaffeNet -cluster 2 -mesh 2,2: the final "
              "model (or the losses) not byte-equal to one process's")
        name = os.path.basename(csolver).split("_")[0]
        state = os.path.join(cdir, f"{name}_train_iter_{MP_SNAP}.solverstate")
        shards = sorted(os.path.basename(p)
                        for p in glob.glob(state + ".shard*"))
        check(shards == [os.path.basename(state) + f".shard{k}"
                         for k in range(2)], f"-mesh 2,2 snapshot: {shards}")
        it, _, hist = checkpoint._read_state(state)
        dense = checkpoint.load_caffemodel_blobs(
            state.replace(".solverstate", ".caffemodel"))
        check(it == MP_SNAP and all(np.isfinite(h).all() for h in hist)
              and dense["fc6"][0].shape == (4096, 9216),
              f"-mesh 2,2 snapshot read back: iter {it}, fc6 "
              f"{dense['fc6'][0].shape}")
        sidecar_bytes = sum(os.path.getsize(os.path.join(cdir, x))
                            for x in shards)
        runs["caffenet_resume_two"], m_r2 = mp_pair(
            K, "CaffeNet -cluster 2 -mesh 2,2 resume 4 -> 8", c_plain,
            ["-mesh", "2,2", "-snapshot", state], {},
            os.path.join(workdir, "mpm_r2"),
            4 * (TRAIN_ITERS - MP_SNAP), device)
        runs["caffenet_resume_one"], m_r1, _ = mp_one(
            K, "CaffeNet -mesh 2,2 resume 4 -> 8", c_plain,
            ["-mesh", "2,2", "-snapshot", state], {},
            os.path.join(workdir, "mpm_r1"), 4 * (TRAIN_ITERS - MP_SNAP),
            device)
        equal["caffenet_resume"] = _file_bytes(m_r2) == m_r1
        for d in (cdir, os.path.join(workdir, "mpm_r2"),
                  os.path.join(workdir, "mpm_r1"),
                  os.path.join(workdir, "mpm_c1")):
            shutil.rmtree(d, ignore_errors=True)
        check(equal["caffenet_resume"], "-mesh 2,2 resume on two "
              "processes: not byte-equal to the same resume in one")
        # (d) validation on the spanning mesh
        # K1 in the TRAIN and TEST nets, K2 in training (every process)
        val_lrn = {MP_LRN[0]: 2 * TRAIN_ITERS + VAL_ROUNDS * VAL_ITER * 2,
                   MP_LRN[1]: 2 * TRAIN_ITERS}
        vone, _, _ = mp_one(
            K, "CaffeNet validating -mesh 1,2", vsolver, ["-mesh", "1,2"],
            {}, os.path.join(workdir, "mpm_v1"), val_lrn, device)
        outs = []
        runs["validate_one"] = vone
        runs["validate_two"], m = mp_pair(
            K, "CaffeNet validating -cluster 2 -mesh 1,2", vsolver,
            ["-mesh", "1,2"], {}, os.path.join(workdir, "mpm_v2"),
            val_lrn, device, outputs=outs)
        os.remove(m)

        def rows(d):
            with open(os.path.join(d, "validation.json")) as f:
                return [json.loads(x) for x in f if x.strip()]
        got = rows(os.path.join(workdir, "mpm_v2"))
        want = rows(os.path.join(workdir, "mpm_v1"))
        val_err = max(abs(g[k] - w[k]) for g, w in zip(got, want)
                      for k in w)
        check(len(got) == len(want) == VAL_ROUNDS and val_err
              <= MPM_VAL_TOL and "validation rounds →" in outs[0]
              and "validation rounds →" not in outs[1],
              f"validation across processes: {got} against {want} (tol "
              f"{MPM_VAL_TOL}); rank 1 wrote rounds: "
              f"{'validation rounds →' in outs[1]}")
        # (e) the timing pair
        timing = {}
        conf = Config(["-conf", lm, "-train", "-device", device])
        for key, dims in (("sp", {"dp": 1, "tp": 1, "sp": 2}),
                          ("tp", {"dp": 1, "tp": 2})):
            port = _free_port()
            kids = mp_children("mesh_steps", [dict(
                server=f"127.0.0.1:{port}", rank=r, solver=lm, dims=dims,
                device=device) for r in range(2)],
                f"the {key} timing pair",
                os.path.join(workdir, f"mpm_steps_{key}"))
            ref, params, _, (ps, _, _) = gs_run(
                K, torch, f"one process {dims}", lm, {}, dims,
                host_batches(conf, 2), MPM_RING + MPM_FLASH[:1],
                steps=MP_DIRECT_STEPS, device=device)
            want = params_digest(params)
            del params, ps
            check(all(k["digest"] == want and k["losses"] == ref["losses"]
                      for k in kids), f"timing pair {key}: two processes' "
                  "params or losses not byte-equal to one process's")
            timing[key] = dict(one_ms=ref["median_step_ms"],
                               one_step_ms=ref["step_ms"],
                               two_ms=kids[0]["median_step_ms"],
                               two_step_ms=kids[0]["step_ms"],
                               bytes_per_step=kids[0]["bytes_per_step"])
        probe = p2p_probe(device)
    finally:
        torch.backends.cudnn.deterministic = prev
    wall = time.monotonic() - t_phase
    log(f"  ppermute across processes: {comm.ROUTES['ppermute']}; gloo "
        f"send / recv on CUDA tensors themselves: {probe}")
    log("  synchronized direct steps, median of 5 (ms): " + "; ".join(
        f"-mesh {'1,1,2' if k == 'sp' else '1,2'} one process "
        f"{t['one_ms']:.2f}, two processes {t['two_ms']:.2f} (gloo bytes a "
        f"step a process: {t['bytes_per_step']})" for k, t in timing.items()))
    log(f"  the tp / sp multi-process phase: {wall:.1f} s; -mesh 2,2 "
        f"sidecars {sidecar_bytes} bytes; validation within {val_err:.3g}")
    return dict(runs=runs, byte_equal=equal, val_err=val_err,
                sidecar_bytes=sidecar_bytes, timing=timing, probe=probe,
                split_bytes=dict(one=tp1["split_bytes"],
                                 two=tp2["split_bytes"]),
                route=comm.ROUTES["ppermute"], wall_s=wall)


def ptxas_report(text: str, keep) -> list:
    """Registers and spills of each kernel instantiation whose mangled
    name `keep` accepts, from the `-Xptxas -v` output of nvcc (names
    demangled by c++filt where the machine has it)."""
    import re
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            if keep(cur["kernel"]):
                out.append(cur)
            cur = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in out), capture_output=True, text=True,
            timeout=30).stdout.splitlines()
        if len(names) == len(out):
            for r, n in zip(out, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child_main(argv[1:])     # one process of phase 34 or 35
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from caffeonspark_tpu_torch.models import zoo
        from caffeonspark_tpu_torch.ops import cuda_build
        from caffeonspark_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the package is not importable here: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    import threading
    from caffeonspark_tpu_torch import native
    built: dict = {}

    def build_native():
        try:
            built["report"] = native.build()
        except Exception as e:       # noqa: BLE001 — checked below
            built["error"] = e

    g_plus = threading.Thread(target=build_native)
    g_plus.start()               # g++ beside nvcc
    report = cuda_build.build_all(verbose=True)
    log(f"build: {report['seconds']:.2f} s (built {report['built']})")
    g_plus.join()
    check("error" not in built, f"native build failed: {built.get('error')}")
    check(native.available(), "the native byte moves did not load")
    have = host_libraries()
    log(f"native ingest library: built {built['report']['built']} in "
        f"{built['report']['seconds']:.2f} s; host libraries: libjpeg "
        f"{'yes' if have['libjpeg'] else 'no'}, cv2 {have['cv2'] or 'no'}, "
        f"PIL {have['PIL'] or 'no'}")
    for name, text in report["nvcc"].items():
        if text.strip() and name not in ("flash_attn", "lrn"):
            log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    # the flash kernels, and lrn.cu's: K4's (k4::bwd, k4::bwd_wide,
    # k4::sum_partials) and K1-K3's (staged::fwd, staged::bwd) at
    # local_size 5 (pad 2) and their runtime-window variants
    ptxas = ptxas_report(report["nvcc"].get("flash_attn", ""),
                         lambda k: "flash_" in k)
    ptxas += ptxas_report(report["nvcc"].get("lrn", ""), lambda k: "2k4" in k
                          or ("6staged" in k and ("Li2E" in k
                                                  or "wide" in k)))
    for r in ptxas:
        log(f"  ptxas {r['kernel'][:90]}: {r['registers']} registers, "
            f"spill stores {r.get('spill_stores')} loads "
            f"{r.get('spill_loads')}")

    log("kernels against their plain versions (B=64 serving and B=256 "
        "training shapes; flash attention at the LM's shapes):")
    res = kernel_phase(K, torch)
    if "--kernels-only" in argv:
        return 0

    workdir = os.path.join(os.path.dirname(os.path.abspath(
        cuda_build.__file__)), "..", "..", "build", "chip_smoke")
    workdir = os.path.normpath(workdir)
    os.makedirs(workdir, exist_ok=True)
    log("writing full-width models:")
    caffenet = write_model(workdir, zoo.caffenet, seed=1)
    alexnet = write_model(workdir, zoo.alexnet, seed=2)

    configs = [  # (label, solver + model, knobs, rows tolerance)
        ("CaffeNet f32", caffenet, {}, ROWS_F32_TOL),
        ("AlexNet bias+relu+LRN int8", alexnet,
         {"COS_FUSE_BIAS_RELU_LRN": "1", "COS_SERVE_WEIGHT_DTYPE": "int8"},
         ROWS_INT8_TOL)]
    log("serving (counts zeroed):")
    K.reset_launch_counts()
    serve = [serve_phase(K, torch, *files, env, tol, label)
             for label, files, env, tol in configs]
    serve_launches = dict(K.launch_counts)
    log(f"launches on the serving path: {serve_launches}")
    for name in ("lrn_across_channels", "bias_relu_lrn_across_channels",
                 "int8_matmul"):
        check(serve_launches.get(name, 0) > 0,
              f"{name} was never launched on the serving path")

    log("profile of one B=64 flush per net (after the counts):")
    profiles = [profile_flush(torch, *files, env, label)
                for label, files, env, _ in configs]

    log("training data and configurations:")
    lmdb = write_train_data(workdir)
    train_configs = [  # (label, solver, knobs, kernels of the path)
        ("CaffeNet train", write_train_config(workdir, zoo.caffenet, lmdb,
                                              seed=1), {},
         ("lrn_across_channels", "lrn_across_channels_bwd")),
        ("AlexNet train bias+relu+LRN",
         write_train_config(workdir, zoo.alexnet, lmdb, seed=2),
         {"COS_FUSE_BIAS_RELU_LRN": "1"},
         ("bias_relu_lrn_across_channels",
          "bias_relu_lrn_across_channels_bwd"))]
    log(f"training through the CLI (-train, B={TRAIN_B}, {TRAIN_ITERS} "
        "steps, the default COS_TRANSFORM_THREADS=2; counts zeroed before "
        "each):")
    train, train_launches, trained = [], {}, {}
    for label, solver_path, env, kernels in train_configs:
        rec, model = train_phase(K, label, solver_path, env,
                                 os.path.join(workdir, label.split()[0]
                                              .lower() + "_out"), kernels)
        train.append(rec)
        trained[label] = (solver_path, model)
        for k, v in rec["launches"].items():
            train_launches[k] = train_launches.get(k, 0) + v

    log(f"ingest: CaffeNet -train for {INGEST_ITERS} steps at "
        "COS_TRANSFORM_THREADS=0, at the default 2, and at 2 with "
        "COS_DEVICE_TRANSFORM=1 (native crop; COS_NATIVE=0; "
        f"COS_STEPS_PER_LOOP={GRAPH_K}) (cuDNN deterministic, so that the "
        "runs' losses can be held equal; counts zeroed before each):")
    ingest_solver = write_train_config(workdir, zoo.caffenet, lmdb, seed=1,
                                       ingest=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ingest_runs = [train_phase(
            K, f"CaffeNet ingest {what}", ingest_solver, env,
            os.path.join(workdir, f"caffenet_ingest_{key}_out"),
            train_configs[0][3], capture=INGEST_BATCHES,
            iters=INGEST_ITERS, launches_each=2 * INGEST_ITERS,
            steady=True)[0]
            for key, what, env in (
                ("t0", "threads 0", {"COS_TRANSFORM_THREADS": "0"}),
                ("t2", "threads 2", {}),
                ("dx", "threads 2 device transform",
                 {"COS_DEVICE_TRANSFORM": "1"}),
                ("dxn", "threads 2 device transform COS_NATIVE=0",
                 {"COS_DEVICE_TRANSFORM": "1", "COS_NATIVE": "0"}),
                ("dxg", f"threads 2 device transform K={GRAPH_K}",
                 {"COS_DEVICE_TRANSFORM": "1",
                  "COS_STEPS_PER_LOOP": str(GRAPH_K)}))]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ingest = ingest_checks(torch, ingest_solver, ingest_runs)
    log("native ingest: crop/mirror against numpy at the training batch, "
        "the feeder's rate:")
    native_res = native_phase(torch, ingest_solver, ingest_runs)
    ingest["runs"] = {r["label"]: {
        k: r[k] for k in ("median_step_ms", "images_per_s",
                          "steady_step_ms", "steady_images_per_s",
                          "pack_ms_p50", "stage_ms_p50", "queue_wait_ms_p50",
                          "dispatch_ms_p50", "wall_s")}
        for r in ingest_runs}
    for r in ingest_runs:
        r.pop("batches")

    log(f"validating training through the CLI (the stock train_val shape: "
        f"a TEST layer of B={VAL_B} on {VAL_RECORDS} records, "
        f"test_interval 4, test_iter {VAL_ITER}; counts zeroed before "
        "each):")
    test_lmdb = write_train_data(workdir, "test_lmdb", VAL_RECORDS, seed=11)
    val_lrn = 2 * TRAIN_ITERS + VAL_ROUNDS * VAL_ITER * 2
    validating, val_launches, val_models = [], {}, {}
    for (label, _, env, kernels), zoo_fn, seed in zip(
            train_configs, (zoo.caffenet, zoo.alexnet), (1, 2)):
        label = label.replace(" train", " train+validate")
        solver_path = write_train_config(workdir, zoo_fn, lmdb, seed,
                                         test_lmdb=test_lmdb)
        rec, model = train_phase(
            K, label, solver_path, env,
            os.path.join(workdir, label.split()[0].lower() + "val_out"),
            kernels, expect={kernels[0]: val_lrn}, rounds=VAL_ROUNDS)
        validating.append(rec)
        val_models[label] = (solver_path, model)
        for k, v in rec["launches"].items():
            val_launches[k] = val_launches.get(k, 0) + v

    log(f"-test and -features fc8 of the trained CaffeNet over the "
        f"{VAL_RECORDS} TEST records, each against the all-plain run "
        "(counts zeroed before each):")
    val_solver, val_model = val_models["CaffeNet train+validate"]
    evals = [eval_phase(K, f"CaffeNet {mode}", val_solver, val_model,
                        os.path.join(workdir, f"caffenet_{mode}_out"), mode,
                        ("lrn_across_channels",),
                        2 * math.ceil(VAL_RECORDS / VAL_B))
             for mode in ("test", "features")]
    # the last round validated the final model on the same 100 records
    last = validating[0]["validation"][-1]
    got = evals[0]["test_result"]
    check(all(abs(got[k][0] - last[k]) <= 1e-6 * max(abs(last[k]), 1.0)
              for k in last),
          f"-test {got} differs from the last validation round {last}")

    log("one solver step with the kernels against the plain step:")
    steps, reuse = [], []
    for label, solver_path, env, _ in train_configs:
        rec, kept = step_vs_plain(K, torch, label, solver_path, env)
        steps.append(rec)
        reuse.append((label, kept))

    log("the trained CaffeNet served (-serve of the -train output):")
    served_trained = serve_phase(K, torch, *trained["CaffeNet train"], {},
                                 ROWS_F32_TOL, "CaffeNet trained",
                                 sizes=(4, 4))

    log("profile of one training step per net:")
    train_profiles = []
    for label, (solver, params, state, host) in reuse:
        train_profiles.append(profile_train_step(torch, label, solver,
                                                 params, state, host))
        del solver, params, state, host

    log(f"transformer LM {LM} through the CLI (-train, DataFrameSource, "
        f"{TRAIN_ITERS} Adam steps; counts zeroed before):")
    lm_solver = write_lm_config(workdir)
    # the phase starts on an empty allocator cache, as a run of its own
    # would (the image nets' phases leave gigabytes cached)
    del reuse
    gc.collect()
    torch.cuda.empty_cache()
    lm_kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    lm_train, _ = train_phase(
        K, "TransformerLM train", lm_solver, {},
        os.path.join(workdir, "transformerlm_out"), lm_kernels,
        per_step=LM["batch"] * LM["seq"], unit="tokens",
        launches_each=LM["layers"] * TRAIN_ITERS)
    lm_launches = dict(lm_train["launches"])
    log("one LM solver step with the kernels against the plain step:")
    lm_step, (solver, params, state, host) = step_vs_plain(
        K, torch, "TransformerLM train", lm_solver, {},
        grad_tol=LM_STEP_GRAD_TOL, plain_forwards=("flash_attention_fwd",))
    lm_step["direct_step_ms"] = direct_steps(torch, solver, params, state,
                                             host)
    log(f"  TransformerLM train: {len(lm_step['direct_step_ms'])} steps "
        "called directly on the main thread, each synchronized: "
        + ", ".join(f"{x:.1f}" for x in lm_step["direct_step_ms"])
        + f" ms (median {median(lm_step['direct_step_ms']):.1f})")
    log("profile of one LM training step:")
    lm_profile = profile_train_step(
        torch, "TransformerLM train", solver, params, state, host,
        what=f"one B={LM['batch']} T={LM['seq']} LM training step")
    del solver, params, state, host

    log(f"the same LM on an sp{SP} mesh through the CLI (-train -mesh "
        f"1,1,{SP}: the ring, its {SP} ranks on the one card, "
        f"{TRAIN_ITERS} Adam steps; counts zeroed before):")
    gc.collect()
    torch.cuda.empty_cache()
    sp_kernels = ("flash_block_update", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
    hops = SP * (SP + 1) // 2     # causal: K9 hops = K7/K8 pairs a layer
    sp_train, _ = train_phase(
        K, "TransformerLM train sp", lm_solver, {},
        os.path.join(workdir, "transformerlm_sp_out"), sp_kernels,
        per_step=LM["batch"] * LM["seq"], unit="tokens",
        launches_each=LM["layers"] * hops * TRAIN_ITERS,
        args=("-mesh", f"1,1,{SP}"))
    sp_launches = dict(sp_train["launches"])
    log("one sp step with the kernels against the plain step, the step "
        "with only K9 plain, and the single-device kernel step:")
    from caffeonspark_tpu_torch.ops.layers import flash_mesh
    from caffeonspark_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh(sp=SP, devices=[torch.device("cuda")] * SP)
    sp_step, (solver, params, state, host) = step_vs_plain(
        K, torch, "TransformerLM train sp", lm_solver, {},
        grad_tol=LM_STEP_GRAD_TOL, plain_forwards=("flash_block_update",),
        mesh=mesh)

    def sp_train_step(params, state, inputs):
        # the processor's step under -mesh
        with flash_mesh(mesh):
            return solver.train_step(params, state, inputs)

    sp_step["direct_step_ms"] = direct_steps(torch, solver, params, state,
                                             host, step=sp_train_step)
    log(f"  TransformerLM train sp: {len(sp_step['direct_step_ms'])} steps "
        "called directly on the main thread, each synchronized: "
        + ", ".join(f"{x:.1f}" for x in sp_step["direct_step_ms"])
        + f" ms (median {median(sp_step['direct_step_ms']):.1f})")
    log("profile of one sp LM training step:")
    sp_profile = profile_train_step(
        torch, "TransformerLM train sp", solver, params, state, host,
        what=f"one B={LM['batch']} T={LM['seq']} sp{SP} LM training step",
        step=sp_train_step)
    del solver, params, state, host, sp_train_step

    wide_lms = {}
    for key, lm in (("h256", LM256), ("h512", LM512)):
        gc.collect()
        torch.cuda.empty_cache()
        wide_lms[key] = wide_lm_phase(K, torch, workdir, key, lm)

    log(f"the standalone trainer (mini_cluster, B={TRAIN_B}, "
        f"{TRAIN_ITERS} steps, counts zeroed before each run): CaffeNet "
        "-dtype float32 and mixed, AlexNet mixed (COS_FUSE_BIAS_RELU_LRN"
        "=1), each mixed step against the plain step, COS_STATE_DTYPE:")
    gc.collect()
    torch.cuda.empty_cache()
    image_mc = image_mc_phase(K, torch, workdir, train_configs)
    log(f"the LM through mini_cluster (-dtype float32, mixed, bfloat16; "
        f"-mesh 1,1,{SP} mixed; counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    lm_mc = lm_dtype_phase(K, torch, workdir, lm_solver, mesh)
    log(f"encoded records: an LMDB of {ENCODED_RECORDS} JPEG Datums, "
        "CaffeNet -train on it (counts zeroed before):")
    gc.collect()
    torch.cuda.empty_cache()
    encoded = encoded_phase(K, torch, workdir, have, train_configs[0][3])
    log(f"COS_STEPS_PER_LOOP={GRAPH_K}: the LM through mini_cluster as CUDA "
        "graphs of K steps against K=1 (float32, mixed, bfloat16; sp4 "
        f"mixed at K={GRAPH_SP_K}), direct and profiled chunks:")
    gc.collect()
    torch.cuda.empty_cache()
    graph_lm = graph_lm_phase(K, torch, workdir, lm_solver, lm_mc)
    log(f"COS_STEPS_PER_LOOP={GRAPH_K}: validating CaffeNet through the CLI "
        "with single-step remainders, against K=1 (counts zeroed before "
        "each):")
    gc.collect()
    torch.cuda.empty_cache()
    graph_cn = graph_caffenet_phase(K, torch, workdir, lmdb, test_lmdb,
                                    train_configs[0][3], train_configs[0][1])
    log(f"the wider zoo: GoogLeNet at B={ZOO_B}, crop {ZOO_CROP} through the "
        "CLI with K1 + K2, then with COS_FUSE_BIAS_RELU_LRN=1 (K3 + K4 on "
        "norm2), each step against the plain step (counts zeroed before "
        "each run):")
    gc.collect()
    torch.cuda.empty_cache()
    googlenet = googlenet_phase(K, torch, workdir, lmdb, res)
    log(f"ResNet-50 at B={ZOO_B}: -train, the running statistics, the step "
        f"against the plain step, -test, mini_cluster K=1 / K={GRAPH_K} and "
        "mixed (counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    resnet = resnet_phase(K, torch, workdir, lmdb, test_lmdb)
    log(f"write-behind snapshots: VGG-16 at B={ZOO_B} and the LM, "
        f"{TRAIN_ITERS} steps with a snapshot at 4, synchronous and "
        "-async_snapshot (counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    vgg_solver, vgg_weights, _ = write_zoo_config(workdir, zoo.vgg16, lmdb,
                                                  VGG_SOLVER, seed=6)
    vgg = snapshot_phase(K, "VGG16 train", vgg_solver,
                         os.path.join(workdir, "vgg16_out"), (), 0, ZOO_B,
                         "images", first_loss=VGG_FIRST_LOSS)
    vgg["weights"] = vgg_weights
    vgg["direct_step_ms"] = zoo_direct_steps(torch, "VGG16 train",
                                             vgg_solver)
    gc.collect()
    torch.cuda.empty_cache()
    lm_snap = snapshot_phase(K, "TransformerLM train", lm_solver,
                             os.path.join(workdir, "transformerlm_snap"),
                             lm_kernels, LM["layers"] * TRAIN_ITERS,
                             LM["batch"] * LM["seq"], "tokens")
    log("HDF5 snapshots: CaffeNet 2 steps and a resume to 4, in HDF5 and in "
        "binaryproto (counts zeroed before):")
    gc.collect()
    torch.cuda.empty_cache()
    hdf5 = hdf5_phase(K, torch, workdir, lmdb, train_configs[0][3])
    log("the quant sidecar: AlexNet in int8, exported and served from its "
        "sidecar (counts zeroed before the server):")
    sidecar = sidecar_phase(K, torch, *alexnet)
    log(f"lstm_lm {LSTM_LM} through the CLI (-train, LRCN's solver, "
        f"{TRAIN_ITERS} steps) and mini_cluster (float32, mixed, bfloat16; "
        f"K=1 and COS_STEPS_PER_LOOP={GRAPH_K}), direct and profiled steps "
        "and chunks (counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    lstm, lstm_vocab = lstm_lm_phase(K, torch, workdir)
    log(f"captions: CaffeNet -features fc8 of {CAPTION_IMAGES} images, the "
        "LRCN captioner at lrcn_cos widths trained on them through the CLI, "
        "greedy / incremental / beam decode (counts zeroed before each):")
    gc.collect()
    torch.cuda.empty_cache()
    caption = caption_phase(K, torch, workdir, lstm_vocab,
                            val_models["CaffeNet train+validate"][1])
    log("the stateless layer types on the card against the CPU port "
        "(counts zeroed before):")
    gc.collect()
    torch.cuda.empty_cache()
    layers = layer_phase(K, torch)
    check("reference" in encoded, "the data path phase needs phase 20's "
          "JPEG Datums, and this machine has no JPEG encoder")
    log("the rest of the data path: the same JPEG Datums through a "
        "SequenceFile (binary2sequence), a LevelDB, an ImageData list "
        "(finetune_flickr_style) and a JSON DataFrame into CaffeNet, each "
        "through the CLI (counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    datapath = datapath_phase(K, torch, workdir, encoded.pop("reference"),
                              test_lmdb, train_configs[0][3])
    log("dp and tp ranks sharing the card (ParallelSolver; CaffeNet and "
        f"AlexNet at the global B={TRAIN_B} over -mesh 1, 2 and 4, ZeRO-1, "
        f"K={GRAPH_K} graphs, evaluation on the mesh, the LM at -mesh 2,2 "
        "and 2,1,2 through mini_cluster; cuDNN deterministic; counts zeroed "
        "before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    dp = dp_phase(K, torch, workdir, lmdb, test_lmdb,
                  val_models["CaffeNet train+validate"][0],
                  val_models["CaffeNet train+validate"][1], lm_solver,
                  lm_mc["runs"]["mixed"])
    log("the gradient exchange (COS_GRAD_SYNC) over the dp ranks: CaffeNet "
        f"at the global B={TRAIN_B}, dp 2 and 4, default / bucket / hier / "
        f"quant / quant int8, {GS_STEPS} direct steps each, ZeRO-1, "
        f"K={GRAPH_K} graphs, the overlap under hooks, the f32 LM at -mesh "
        "2,2; cuDNN deterministic; counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    gsync = gradsync_phase(K, torch, workdir, lmdb, lm_solver)
    log("data-parallel training across processes: CaffeNet at the global "
        f"B={TRAIN_B} as two processes sharing the card (mini_cluster "
        "-server 127.0.0.1:<port> -cluster 2 -rank I, gloo), against one "
        "process's -mesh 2 and -mesh 4; ZeRO-1 sidecars; the collectives' "
        "routes; synchronized steps by exchange mode; cuDNN deterministic; "
        "counts zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    multiproc = multiproc_phase(K, torch, workdir, lmdb)
    log("the tp and sp axes across processes: two processes sharing the "
        "card (mini_cluster -cluster 2 -mesh 1,1,2 / 1,2 / 2,2, gloo), each "
        "holding half of the global mesh: the full-width LM's ring and "
        "head blocks, CaffeNet's fc6 / fc7 columns, their sidecars and "
        "resume, validation, the timing pair; cuDNN deterministic; counts "
        "zeroed before each run):")
    gc.collect()
    torch.cuda.empty_cache()
    mpmesh = multiproc_mesh_phase(K, torch, workdir, lmdb, test_lmdb,
                                  lm_solver)
    mc_paths = {f"mc_{r['label'].split()[0].lower()}_{r['dtype']}": r
                for r in image_mc["runs"] + list(lm_mc["runs"].values())}
    mc_paths["mc_transformerlm_dp2tp2_mixed"] = dp["lm_dp2_tp2"]
    mc_paths["mc_transformerlm_dp2sp2_mixed"] = dp["lm_dp2_sp2"]
    mc_paths["mc_transformerlm_sp4_mixed"] = lm_mc["sp_run"]
    mc_paths["mc_caffenet_state_dtype"] = image_mc["state_dtype"]
    for dtype, r in graph_lm["runs"].items():
        mc_paths[f"mc_transformerlm_{dtype}_k{GRAPH_K}"] = r
    mc_paths[f"mc_transformerlm_sp4_mixed_k{GRAPH_SP_K}"] = graph_lm["sp_run"]
    mc_paths["mc_transformerlm_sp4_mixed_k1_4steps"] = graph_lm["sp_run_k1"]
    for key in ("k1", f"k{GRAPH_K}"):
        mc_paths[f"mc_resnet50_float32_{key}"] = resnet["mc"][key]
    mc_paths["mc_resnet50_mixed"] = resnet["mixed"]
    mc_paths["mc_resnet50_float32"] = resnet["f32_2_steps"]
    for dtype in ("float32", "mixed", "bfloat16"):
        mc_paths[f"mc_lstmlm_{dtype}"] = lstm["runs"][dtype]
        mc_paths[f"mc_lstmlm_{dtype}_k{GRAPH_K}"] = lstm["graphed"][dtype]

    lines = []
    for name, meta in KERNELS.items():
        main_rec = res[name][0]
        by_path = {"serve": serve_launches.get(name, 0),
                   "train": train_launches.get(name, 0),
                   "ingest": sum(r["launches"].get(name, 0)
                                 for r in ingest_runs),
                   "validate": val_launches.get(name, 0),
                   **{e["mode"]: e["launches"].get(name, 0)
                      for e in evals},
                   "train_lm": lm_launches.get(name, 0),
                   "train_lm_sp": sp_launches.get(name, 0),
                   **{f"train_lm_{key}": w["launches"].get(name, 0)
                      for key, w in wide_lms.items()},
                   **{path: r["launches"].get(name, 0)
                      for path, r in mc_paths.items()},
                   **({"encoded": encoded["train"]["launches"].get(name, 0)}
                      if "train" in encoded else {}),
                   **{f"graph_caffenet_k{k}": r["launches"].get(name, 0)
                      for k, r in graph_cn["runs"].items()},
                   **{f"train_googlenet_{k}": r["launches"].get(name, 0)
                      for k, r in googlenet["runs"].items()},
                   "train_resnet50": resnet["train"]["launches"].get(name, 0),
                   "test_resnet50": resnet["test"]["launches"].get(name, 0),
                   **{f"train_{net}_{k}": r["launches"].get(name, 0)
                      for net, rec in (("vgg16", vgg), ("lm_snapshots",
                                                        lm_snap))
                      for k, r in rec["runs"].items()},
                   "hdf5_caffenet": hdf5["launches"].get(name, 0),
                   "serve_quant_sidecar": sidecar["launches"].get(name, 0),
                   "train_lstm_lm": lstm["train"]["launches"].get(name, 0),
                   "caption_features":
                       caption["features"]["launches"].get(name, 0),
                   "train_captioner":
                       caption["train"]["launches"].get(name, 0),
                   "caption_decode":
                       caption["decode_launches"].get(name, 0),
                   "layers": layers["launches"].get(name, 0),
                   **{f"datapath_{k[2:]}": r["launches"].get(name, 0)
                      for k, r in datapath["runs"].items()},
                   **{f"dp_{k}": r["launches"].get(name, 0)
                      for k, r in dp["runs"].items()},
                   **{f"dp_{e['mode']}_mesh2": e["launches"].get(name, 0)
                      for e in dp["eval"]},
                   **{f"gradsync_{k}": r["launches"].get(name, 0)
                      for k, r in gsync["runs"].items()},
                   **{f"multiproc_{k}": (
                       sum(c.get(name, 0) for c in r["launches"])
                       if isinstance(r["launches"], list)
                       else r["launches"].get(name, 0))
                      for k, r in multiproc["runs"].items()},
                   **{f"multiproc_mesh_{k}": (
                       sum(c.get(name, 0) for c in r["launches"])
                       if isinstance(r["launches"], list)
                       else r["launches"].get(name, 0))
                      for k, r in mpmesh["runs"].items()}}
        by_dtype: dict = {}
        for r in mc_paths.values():
            for key, v in r.get("launches_by_dtype", {}).items():
                k, dt = key.split(":")
                if k == name:
                    by_dtype[dt] = by_dtype.get(dt, 0) + v
        lines.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=sum(by_path.values()),
            launches_by_path=by_path, mini_cluster_launches_by_dtype=by_dtype,
            max_abs_err=max(r["max_abs_err"] for r in res[name]
                            if r["dtype"] in ("float32", "int8")),
            ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"], library=meta["library"],
            shape=main_rec["shape"], dtype=main_rec["dtype"],
            **{key: main_rec[key] for key in ("bound_route",
                                              "f32_simt_bound_ms")
               if key in main_rec}))
    for line in lines:
        check(line["launches"] > 0,
              f"{line['name']} was never launched on a main path")
        if line["name"] != "int8_matmul":
            check(line["mini_cluster_launches_by_dtype"].get("bfloat16", 0)
                  > 0, f"{line['name']} was never launched in bf16 on "
                  "mini_cluster's paths")
    log(json.dumps({"serving": serve, "profile": profiles}))
    log(json.dumps({"training": train, "step_vs_plain": steps,
                    "trained_served": served_trained,
                    "train_profile": train_profiles}))
    log(json.dumps({"validating": validating, "eval": evals,
                    "ingest": ingest}))
    log(json.dumps({"training_lm": lm_train, "lm_step_vs_plain": lm_step,
                    "lm_train_profile": lm_profile}))
    log(json.dumps({"training_lm_sp": sp_train,
                    "lm_sp_step_vs_plain": sp_step,
                    "lm_sp_train_profile": sp_profile}))
    for key, w in wide_lms.items():
        log(json.dumps({f"training_lm_{key}": w["train"],
                        f"lm_{key}_step_vs_plain": w["step"],
                        f"lm_{key}_train_profile": w["profile"]}))
    log(json.dumps({"mini_cluster_image": image_mc}))
    log(json.dumps({"mini_cluster_lm": lm_mc}))
    log(json.dumps({"native": native_res, "host_libraries": have,
                    "encoded": encoded}))
    log(json.dumps({"graphs": {"lm": graph_lm, "caffenet": graph_cn}}))
    log(json.dumps({"zoo": {"googlenet": googlenet, "resnet50": resnet}}))
    log(json.dumps({"snapshots": {"vgg16": vgg, "lm": lm_snap,
                                  "hdf5": hdf5},
                    "quant_sidecar": sidecar}))
    log(json.dumps({"lstm_lm": lstm, "caption": caption,
                    "layers": layers}))
    log(json.dumps({"datapath": datapath}))
    log(json.dumps({"dp": dp}))
    log(json.dumps({"gradsync": gsync}))
    log(json.dumps({"multiproc": multiproc}))
    log(json.dumps({"multiproc_mesh": mpmesh}))
    log(json.dumps({"ptxas": ptxas}))
    log(json.dumps({"kernel_records": res}))
    log(json.dumps({"kernels": lines}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
