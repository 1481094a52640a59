#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one CUDA card and check
every kernel of its main paths.

    python3 chip_smoke.py              # one card, every phase below
    python3 chip_smoke.py --ranks 4    # four cards: the mesh path only
    python3 chip_smoke.py --prefills ROOT   # one card: the serve and llama
                                       # phases' cold prefills, ROOT's package

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX or of the JAX package. Phases, in order; any failure raises and the
script exits non-zero:

  1. device  the card's name and power limit (nvidia-smi)
  2. build   compile ray_tpu_torch/csrc with nvcc, one process per source,
             all at once (timed); show ptxas's register / spill report and
             fail if a tensor-core (sm90) instance or an instance of the
             register-tiled fp32 forward spills
  3. kernel  flash_attn_fwd against its plain PyTorch version on the card,
             o and lse, fp32 and bf16, head dims 32, 64 and 128, ragged and
             aligned lengths, bitwise repeatable, with a digest of each
             case's outputs (to compare commits bitwise); times of the
             kernel, the plain version and SDPA (yardstick only) at the serving and
             training shapes, beside the least time the card could take,
             with the kernel's achieved TFLOP/s, its share of that bound
             and its ratio to SDPA; at B = 1 each also as device time from
             one torch.profiler window; for each timed fp32 shape the tile
             plan (fwd_block_m) and the kernel's time at every fp32 tile
  4. bwd     flash_attn_bwd's dq and dk/dv kernels against their plain
             version on the card (and, in fp32, against autograd of the
             plain attention), fp32 and bf16, head dims 32, 64 and 128,
             ragged and aligned lengths, bitwise repeatable, with a digest
             of each gradient; times at the training shapes (and fp32 at
             (1, 12, 1024, 64)) beside the bound, the plain backward and
             SDPA's backward (yardstick only), with achieved TFLOP/s,
             share of the bound and ratio to SDPA's backward
  5. model   GPT-2-124M forward at (4, 512) on the card against the same
             weights' forward on the CPU plain path
  6. serve   the serving path: LLMEngine over build_adapter("gpt2") at
             full width answers 8 requests (one prefix-cache hit); the
             forward kernel's launch counter, the cache's integrity, and a
             teacher-forced check of every greedy token against the CPU
             plain forward; the engine's six ray_tpu_llm_* series and the
             count of each llm.* flight event (a series the engine
             publishes unset, or an expected event absent, fails)
  7. train   the training path: TrainStep on GPT-2-124M at full width, bf16
             compute over fp32 master weights, B = 16, T = 1024: a warm-up
             step, then timed steps on a repeated batch with a falling
             loss and exactly 24 forward, 12 dq and 12 dk/dv launches per
             step; step time, tokens/s, MFU and peak memory from the
             port's recorder; one more step inside a device-trace window
             the recorder opens (request_device_trace(1): torch.profiler,
             written as a Chrome trace), read back for its kernel times,
             the attention kernels' share and the device's busy share; the
             recorder's slow-step flag; the recorder's report keys through
             publish_report_summary, read back from the port's metric table
             (all seven ray_tpu_train_* gauges under the run's label, each
             equal to its key); then one fp32 step at full width
             on (2, 128) on the card and on the CPU plain path from the
             same weights
  8. llama   Llama-160M at full width (12 layers, 12 heads, 4 KV heads
             repeated to 12 before the kernels, width 768, vocab 32000):
             the fp32 forward at (4, 512) against the CPU, serving as in
             phase 6 (build_adapter("llama-160m")), training as in phase 7
             (bf16, B = 16, T = 1024, with the exact 6N MFU beside the
             recorder's), one fp32 step on (2, 128) against the CPU, and
             models/llama.py's loss_fn on the fp32 forward's logits against
             the loss TrainStep reports (1e-4 relative)
  9. spec    speculative decoding: the Llama-160M target answers phase 6's
             prompts without a draft and with two (a same-seed llama-160m,
             acceptance near 1; llama-tiny at vocabulary 32000, near 0),
             k = 4; every stream equals the plain one, or leaves it only
             at a near tie of the CPU plain forward (within GREEDY_TOL);
             acceptance, rounds and tokens/s beside the plain run
 10. moe     GPT2MoEConfig() (GPT-2-124M widths, 8 experts, top-2, an MoE
             block every 2nd layer) trains at B = 8, T = 1024 (a warm-up
             and three timed steps, 24 / 12 / 12 launches each, loss with
             the aux loss falling); one fp32 step on (2, 128) against the
             CPU after its dispatch masks are compared (a routing flip from
             a near tie shows as such); gpt2-moe-tiny serves 4 requests
             (dropless routing) against the CPU
 11. head_dims  head dims the kernels are not built for run on them,
             zero-padded to the next kernel size (16 to 32, 48 to 64):
             gpt2-tiny at head dim 16 serves 4 requests through a small KV
             pool (with preemptions) against the CPU, a GPT2Config(n_head=16)
             bf16 step at head dim 48 takes 24 / 12 / 12 launches and one
             fp32 step on (2, 128) agrees with the CPU, and the padded
             forward and backward at both head dims agree with the plain
             version, all with no plain call; a (5462, 12, 16, 64) bf16
             forward and backward (B * H = 65544, over the grid's 65535)
             runs the kernels in two chunks, against the plain version
 12. mesh    TrainStep on a device mesh at world size 1 over NCCL
             (make_mesh({"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}): FSDP2 over
             the one rank, the tp and sp paths off): GPT-2-124M at full
             width as in phase 7 (bf16, B = 16, T = 1024, a warm-up and five
             timed steps, 24 / 12 / 12 launches and no plain call a step,
             one more in a device-trace window), its step times beside
             phase 7's median; then one fp32 step of
             a 4-layer GPT-2-124M-width and of a 4-layer Llama-160M-width
             model on the mesh against the same step off it (loss and
             grad_norm within 1e-5 relative, parameters within 2 * lr)
 13. moe_mesh  GPT2MoEConfig() through TrainStep on the same one-rank group,
             make_mesh({"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, "ep": 1}), at
             B = 8, T = 1024 bf16 (a warm-up and three timed steps, 24 / 12 /
             12 launches and no plain call a step, one more in a
             device-trace window), its step times beside the moe phase's
             median; then one fp32 step of a 4-layer
             GPT2MoEConfig on the mesh against the same step off it (1e-5
             relative, 2 * lr)
 14. pipeline  PipelineTrainStep(GPT2Config.gpt2_124m(), make_mesh({"dp": 1,
             "pp": 1}), num_microbatches=2) at B = 16, T = 1024 bf16 (a
             warm-up and three timed steps; launches per step the
             schedule's: 12 x 2 x 2 forward with remat, 12 x 2 dq, 12 x 2
             dk/dv, no plain call); then fp32 steps of a 4-layer
             GPT-2-124M-width model on (4, 128): 4 microbatches against 1
             on the card, and the card against the port's CPU step from
             the same weights (1e-5 relative, 2 * lr)

 15. runtime  the port's runtime with the card as its device (after the
             NCCL group is destroyed): ray_tpu_torch.init(num_cpus=4)
             autodetects it (cluster_resources()["GPU"] equals the cards
             torch sees); a first num_gpus=1 task times the lease (the
             worker's fork, torch import and CUDA context); a num_gpus=1
             actor builds GPT-2-124M (fp32) on its leased card and serves
             phase 6's prompts through LLMEngine: the forward kernel
             launches in the actor, no plain call, its
             CUDA_VISIBLE_DEVICES is its get_accelerator_ids(), and its
             streams equal phase 6's or leave them only at a near tie of
             the CPU plain forward; a num_gpus=1 task trains GPT-2-124M
             as in phase 7 for 3 steps (24 / 12 / 12 launches a step, no
             plain call; losses within 1e-3 relative of phase 7's first
             three); a 256 MiB bf16 CUDA tensor goes through put, a GPU
             task and get, and comes back bitwise equal as a CPU tensor
             (put, task and get ms); every process the runtime started is
             stopped
 16. serve_deploy  the serve deployment on the runtime (a new
             init(num_cpus=4)): llm.deploy(model="gpt2", seed=0) starts one
             replica on one leased card (replica start split into the
             lease with the worker's start and torch import, the model
             build, serve.run's ready check); phase 6's prompts as 8
             concurrent llm.stream streams x 32 greedy tokens, a warm-up
             run and a timed one (every prompt then a prefix-cache hit),
             plus one generate and one handle call: time to first token
             per stream, tokens/s beside phase 6 and the runtime's actor,
             every stream equal to phase 6's or leaving it only at a near
             tie; inside the replica (a subclass of LLMReplica this script
             defines, bound through llm.deploy's own code) the forward
             kernel launches and no plain attention call runs. Then
             llm.deploy(model="llama-160m", draft_model="llama-160m",
             spec_k=4): streams equal phase 9's same-seed run (near-tie
             rule) and, where all are equal, its acceptance equal too.
             Between the two, DeploymentHandle.close as in the JAX package:
             the closed handle leaves the process's long-poll, a call on it
             still answers as before, and a new handle serves a prompt the
             prefix cache has not seen through the forward kernel (launches
             above 0, no plain call, greedy tokens near the CPU's); every
             process the runtime started is stopped
 17. trainer  the trainer on the runtime (a new init(num_cpus=4)):
             TorchTrainer(loop, ScalingConfig(num_workers=1, use_gpu=True),
             RunConfig(storage_path=<tmp>)).fit(), a one-trial Tune run
             whose trial actor (no card, no torch) reserves a placement
             group of one {"GPU": 1, "CPU": 1} bundle and starts one worker
             on its leased card; the loop trains GPT-2-124M as in phase 7
             (bf16, B = 16, T = 1024, phase 7's seed and batch: a warm-up
             and five timed steps, each reported with its loss, ms, and the
             worker's 24 / 12 / 12 launches and 0 plain calls), opens a
             request_device_trace(1) window over one more step, and reports
             a checkpoint of the model's state dict with its digest. Checks:
             the losses within 1e-3 relative of phase 7's and falling, the
             worker's CUDA_VISIBLE_DEVICES equal to its accelerator ids,
             the Result's checkpoint loaded on the CPU bitwise equal to the
             digest, the ray_tpu_train_* gauges in the GCS from the driver
             after fit(), the trace window registered with the GCS. Prints
             fit()'s start-up until the first report (the trial actor, the
             placement group, the worker's lease, its torch import and CUDA
             context, the model build and warm-up step), the median step
             beside phase 7's and fit()'s total beside its steps' sum
 18. data     the trainer fed by a Dataset (a new init(num_cpus=5): the
             worker's bundle holds one CPU, the map and shuffle tasks lease
             the other four): ray_tpu_torch.data.from_numpy of token rows
             (phase 7's batch from default_rng(0), once per step of phase
             7's run, one block each; then 8 batches of further draws in 4
             blocks, shuffled with random_shuffle(seed=0)), split into idx
             / targets by map_batches tasks; TorchTrainer(loop, datasets=
             {"train": ds}, ScalingConfig(num_workers=1, use_gpu=True)).fit()
             trains GPT-2-124M as in phase 7 with every batch from
             get_dataset_shard("train").iter_torch_batches(batch_size=16)
             (pinned host memory, non-blocking copies one batch ahead on a
             side stream), a trace window over two steps and the next()
             between them. Checks: 24 / 12 / 12 launches and no plain call
             a step, every batch on cuda as int64, the first six losses
             within 1e-3 relative of phase 7's and falling, the digest of
             every row the worker got equal to ds.take_all()'s on the
             driver. Prints (not checked) the host ms each next() waited,
             each batch's H2D copy ms from CUDA events, the step ms beside
             phase 7's median, the window's busy share, and the tokens/s
             the iterator alone delivers to the card beside what a step
             consumes
 19. rllib    RLlib with its learners on the card (no gymnasium or pyarrow
             here: CartPole-v1 and Pendulum-v1 are the port's numpy copies;
             no kernel runs on this path): one update of each learner class
             (TorchLearner, ImpalaLearner, AppoLearner, DQNLearner,
             SACLearner with fixed noise, _MarwilLearner) on the card
             against the CPU from the same weights and batch (losses and
             aux within 1e-5 relative, parameters within 1e-5 relative or
             2 * lr, parameters and optimizer state on cuda); then a new
             init(num_cpus=6): PPO with tests/test_rllib.py's config (4
             runners x 8 envs x 64 steps, lr 1e-3, 8 epochs of 256) to a
             mean return of 150 within 120 iterations, its learner actor
             on cuda with its lease's CUDA_VISIBLE_DEVICES, no runner
             process holding torch, gymnasium or JAX (printing iterations,
             each iteration's sampling, update and weights' return seconds,
             the update's env steps per second, the lease's start); APPO
             with tests/test_offline_rl.py's config to 150 within 40
             iterations, learner/kl >= 0; three iterations each of IMPALA
             (its learner on this process's card), DQN, SAC (Pendulum-v1,
             256 x 256) and multi-agent PPO with finite losses and the env
             steps their configs give; PPO at its
             default config (2 runners x 8 envs x 128 steps, 64 x 64, 4
             epochs of 512) for three iterations, saved and restored with
             the weights bitwise in the driver and in the new learner. BC
             and MARWIL read parquet, which needs pyarrow: they run in the
             CPU tests, their learner here
 20. multinode  three nodes on one machine (cluster_utils.Cluster: a head
             with {"CPU": 2, "GPU": 0}, the card node with {"CPU": 2, "GPU":
             1}, a CPU-only node with {"CPU": 2, "GPU": 0}: every raylet
             would claim the card without its explicit count): the GPU total
             is 1 and list_nodes shows three ALIVE nodes, the GPU on the card
             node only; GPT-2-124M's seed-0 fp32 weights, one flat array of
             498 MB in parameter order, put on the head and broadcast_object
             to the others (3 nodes, 2 transfers), read back on each node by
             a task with the driver's digest; two num_gpus=0.5 named actors
             (both on the card node, list_actors says so; a fractional
             lease keeps the node's CUDA_VISIBLE_DEVICES, one card) build
             GPT-2-124M on the card from the broadcast array and serve
             phase 6's 8 prompts x 32 greedy
             tokens through ActorPool.map_unordered (each actor launches the
             forward kernel, no plain call; streams equal phase 6's or leave
             them only at a near tie); the two actors form a util.collective
             group of 2, each runs TrainStep.loss_and_grads in fp32 on one
             row of (2, 128) (24 / 12 / 12 launches, no plain call), flattens
             its gradients into one CUDA tensor, all-reduces it over the
             host ring (in place, on cuda) and halves it: the loss and every
             gradient within 1e-4 relative of the full batch's on the card;
             `python -m ray_tpu_torch.util.client.server --address <gcs>`,
             and a process that imports only ray_tpu_torch.util.client gets
             an actor by name and generates two prompts: int token ids equal
             to the pool's, no torch in that process; remove_node of the
             CPU-only node shows it DEAD within 30 s; every process stopped.
             Prints the cluster's start, the broadcast's seconds and MB/s a
             transfer, the leases' start, the pool's tokens/s beside phases
             6 and 15, the all-reduce's seconds and GB/s with its host copies
             apart, the client's round trip and the phase's total
 21. dag      a compiled graph on the runtime (a new init(num_cpus=4), kept
             for phase 22): GPT-2-124M (bf16 compute, seed-0 weights as the
             JAX package's flax tree through load_flax_params) split over two
             num_gpus=0.5 actors on the card, stage a (wte, wpe, blocks 0-5)
             and stage b (blocks 6-11, ln_f, the tied head); with
             InputNode() as inp: out = b.tail.bind(a.head.bind(inp)),
             experimental_compile(buffer_size_bytes=16 MiB): 8 executes of
             (4, 512) token batches, each awaited, then 4 in flight. Checks:
             the last position's logits within 1e-3 of the max logit of the
             one-process forward on the card (bitwise printed) and the
             greedy tokens, the forward kernel's launch counter read inside
             each actor through __ray_call__ (6 a stage per execute, no plain
             call), a (1, 1025) input raising ValueError at the driver's get()
             with the graph going on, the in-flight, eager and repeated
             outputs equal; LearnerGroup(mesh_devices=cards + 1) raises before
             any actor. Prints ms per execute, compiled beside the same two
             stages chained by eager .remote calls, the hidden state's copies
             to the host and back timed apart, compile and teardown seconds
 22. workflow  a durable workflow of two num_gpus=1 steps: GPT-2-124M's
             forward on the card giving the greedy tokens of a (4, 512) batch
             as numpy, then a step that fails on its first run and returns a
             CUDA tensor of the tokens on its second; workflow.resume finishes
             it. Checks: step 1 ran once (12 launches, no plain call), the
             step ids and meta keys, the output equal to a fresh run's, the
             CUDA tensor back from resume and from storage as a CPU tensor.
             Every process the runtime started is stopped
 23. operator  the operator plane through the CLI, as an operator runs
             it: `ray-tpu-torch start --head --resources '{"CPU": 4, "GPU":
             0}' --dashboard-port 0` (status, /api/cluster, /api/version);
             an Autoscaler over a FakeMultiNodeProvider with one node type
             {"CPU": 2, "GPU": 1} (max_workers 1); a job submitted over HTTP
             (JobSubmissionClient) whose entrypoint calls init(address=
             "auto") and leases a num_gpus=1 actor, the demand that makes
             the autoscaler launch the card's node; the actor serves phase
             6's prompts with GPT-2-124M (seed-0 weights) through LLMEngine.
             Checks: the job SUCCEEDED, its logs over /api/jobs/<id>/logs
             show forward launches > 0 and 0 plain calls and every greedy
             token within 1e-3 of the max logit of the card's plain forward;
             the node in /api/nodes, then gone once idle; a second job
             STOPPED by `job stop`; `perf check --only` writing a ledger in
             a temporary directory that `perf history` and /api/perf read
             back; `stop` leaving no process and no plasma segment. Prints
             start to head ready, submit to SUCCEEDED, the job's tokens/s
             beside phase 6's, demand to node up, idle to node gone and the
             perf check's seconds

Then one JSON line of kernels (launches and plain attention calls per
path: GPT-2 train and serve, Llama train and serve, spec, MoE train, mesh
train, MoE on the mesh, the pipeline, the runtime's actor and task, the
two deployments and the first one's new handle after a close, the
trainer, the trainer fed by a Dataset, the multinode pool and gradients,
the two DAG stages, the workflow step and the operator's job; every
full-width path must show 0 plain calls) and, last,
``{"ok": true, "device": ...}``.

With ``--ranks N`` it needs N cards and runs, after the device and build
phases, only the mesh path across them: N processes, one card each, over
NCCL (``tcp://localhost``). An all-reduce of 256 MB over every card
gives the interconnect's bus bandwidth. Each card trains GPT-2-124M alone
(the one-device step, as in phase 7); then GPT-2-124M trains on each mesh
of RANKS_TRAIN_MESHES (bf16, B = 16, T = 1024, global), launches checked
per rank (2L / L / L at sp = 1; the ring's einsum replaces the kernels at
sp > 1), step times beside the one-device median, and one more step of
each in a device-trace window (kernel time, NCCL's kernels among them,
and the device's busy share); then one fp32 step of
the 4-layer GPT-2-124M-width and Llama-160M-width models on each mesh of
RANKS_PARITY_MESHES against the one-device step on each card (loss and
grad_norm within 1e-4 relative: the sums run in another order across
ranks; parameters within 2 * lr). Then GPT2MoEConfig() trains alone on
each card and on each mesh of RANKS_MOE_MESHES ({"ep": 4}, {"dp": 2,
"ep": 2}) at B = 8, T = 1024, one step of each traced, with a 4-layer
fp32 step on each mesh against one card; the pipeline trains GPT-2-124M on each mesh of
RANKS_PIPE_MESHES ({"dp": 2, "pp": 2}, {"pp": 4}) beside one card's run
at dp 1 x pp 1 (made by the parent process on card 0 before the ranks
start), with a 4-layer fp32 step on each against that card's; and a
GPT-2-124M-width model with 2 heads trains one fp32 step at {"tp": 4}
(each head computed by 2 ranks) against one card. Then, in the main
process, TorchTrainer with N use_gpu workers, one card each (distinct
CUDA_VISIBLE_DEVICES), over one NCCL group the trainer brings up:
GPT-2-124M bf16 on make_mesh({"dp": N}) at the global B = 16 x T = 1024,
each rank's batches from its shard of a Dataset passed as datasets=
(equal blocks, a multiple of N; the ranks' rows disjoint and together
the dataset's, gathered with all_gather_object)
(24 / 12 / 12 launches and no plain call per rank and step, losses
within 1e-3 relative of the dp N run above, step times beside its
median), and one fp32 step of the 4-layer
GPT-2-124M-width model on that mesh against the one-device step on each
card (1e-4 relative, 2 * lr). Last, the port's
runtime on the N cards: a LearnerGroup of N dp learner ranks
(mesh_devices=N, one card each, NCCL) takes PPO's update_from_batch (two
epochs of odd 127-row minibatches) and DQN's update of 254 rows on one
fixed CartPole-v1 batch, against a one-card learner (mesh_devices=1) that
pads each minibatch to N: aux within 1e-5 relative, parameters within
1e-5 relative or 2 * lr, the ranks' parameters bitwise equal, each
update's ms on one card and on N; init detects N GPUs, and N / 2 actors of
num_gpus=2 get disjoint pairs covering them all, each seeing 2 cards;
then llm.deploy(model="gpt2", num_replicas=N) puts N replicas on N
distinct cards, 4 x 8 concurrent streams reach every replica (each
launches the forward kernel, none a plain call), and every stream equals
a one-replica deployment's (near-tie rule against the CPU).
Without CUDA it exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"   # the card; every phase runs on it
LOG = True        # print; off on every rank but 0 with --ranks

FP32_TOL = 2e-5   # kernel vs plain, both fp32 with TF32 off: summation order
BF16_TOL = 2e-2   # bf16 kernel output vs the plain version in fp32 on the
#                   same bf16 inputs: one bf16 rounding of o (|o| < ~3)
# Backward errors are normalised: max |err| / max(max |ref|, 1). dk and dv
# sum over up to T query rows, so their size grows with T; the floor of 1
# keeps a gradient that is exactly 0 (dq and dk at T = 1, where do.v equals
# delta) from dividing rounding noise by rounding noise.
BWD_FP32_TOL = 1e-5  # fp32, TF32 off: summation order over up to T terms
BWD_BF16_TOL = 1e-2  # bf16 output vs the plain version in fp32 on the same
#                      bf16 inputs: one bf16 rounding (2^-9 relative) each
LOGIT_TOL = 1e-3  # GPT-2 logits, card vs CPU, fp32 through 12 layers
GREEDY_TOL = 1e-3  # a card-chosen greedy token vs the CPU's max logit
# fp32 train step, card vs CPU from the same weights: loss and grad_norm to
# 1e-4 relative and every gradient to 1e-4 of its tensor's norm (12 fp32
# layers forward and backward, summation orders differ); parameters after
# the step to 2 * lr (Adam's first step moves each weight by about lr
# whatever its gradient's size, so a near-0 gradient whose sign differs
# moves a weight by up to 2 * lr) plus 1e-6 of rounding.
TRAIN_REL_TOL = 1e-4

# correctness cases (every one in fp32 and bf16): GPT-2's head dim at
# ragged and aligned lengths, and the kernels' other head dims, 32 and 128
KERNEL_SHAPES = ([(1, 12, t, 64) for t in (1, 7, 100, 150, 512, 600, 1024)]
                 + [(2, 4, 128, 32)]
                 + [(1, 4, t, d) for d in (32, 128) for t in (1, 7, 100, 512)])
TRAIN_SHAPE = (16, 12, 1024, 64)   # GPT-2-124M attention at B = 16, T = 1024
# (shape, dtype) pairs timed: the serving widths (fp32 prompts of the serve
# phase's median-ish and longest lengths, 150 and 600, and 512 and 1024; bf16
# at 512 and 1024) and the training shapes (bf16, as the bf16 train step
# gives them); the fp32 backward at one B = 1 shape (the fp32 parity steps)
TIMED_FWD = ([((1, 12, t, 64), torch.float32) for t in (150, 512, 600, 1024)]
             + [((1, 12, t, 64), torch.bfloat16) for t in (512, 1024)]
             + [(TRAIN_SHAPE, torch.bfloat16)])
TIMED_BWD = [((1, 12, 1024, 64), torch.bfloat16), ((1, 12, 1024, 64), torch.float32),
             (TRAIN_SHAPE, torch.bfloat16)]
DEVICE_TIME_TOL = 0.10   # window vs profiler device time: above, PERF.md notes it
HEADLINE = (TRAIN_SHAPE, torch.bfloat16)  # the training path's shape and type

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s for
# the inputs' type (fp32 outside the tensor cores; bf16 dense tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# which design runs each kernel, by dtype (csrc/: the entry points choose)
TENSOR_CORES = "sm90 wgmma+TMA, bf16"
CUDA_CORES = "CUDA cores, fp32"
REGISTER_TILES = "CUDA cores, fp32, register tiles + cp.async"
DESIGN = {"flash_attn_fwd": {"bfloat16": TENSOR_CORES, "float32": REGISTER_TILES},
          "flash_attn_bwd_dq": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES},
          "flash_attn_bwd_dkv": {"bfloat16": TENSOR_CORES, "float32": CUDA_CORES}}

SERVE_WIDTH = (12, 12, 768, 50257, 1024)  # layers, heads, width, vocab, context
FORWARD_SHAPE = (4, 512)      # the fp32 forward checked against the CPU
TRAIN_BATCH = (16, 1024)      # bench.py's GPT-2-124M batch
TRAIN_STEPS = 5               # timed steps after one warm-up step
PARITY_BATCH = (2, 128)       # the fp32 card-vs-CPU step
SERVE_PROMPT_LENS = (16, 41, 97, 150, 233, 318, 480, 600)
PREFILL_WARM_LENS = (150, 600)   # --prefills: the warm forward's prompt lengths
SERVE_MAX_TOKENS = 32
SHARED_PREFIX = 64
# layers, heads, KV heads, width, SwiGLU width, vocab, context
LLAMA_WIDTH = (12, 12, 4, 768, 2048, 32000, 1024)
SPEC_K = 4                    # draft tokens per speculative round
# layers, heads, width, vocab, experts, top-k, an MoE block every n-th
MOE_WIDTH = (12, 12, 768, 50257, 8, 2, 2)
MOE_TRAIN_BATCH = (8, 1024)
MOE_TRAIN_STEPS = 3           # timed steps after one warm-up step
# the head_dims phase: gpt2-tiny as the JAX package's serving test builds it
# (head dim 16), served through a pool small enough to preempt; a 16-head
# GPT-2-124M (head dim 48) step; the padded kernels alone at the shapes those
# paths give them, in fp32 and bf16; and a B * H over the grid's 65535
MESH_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}   # one rank, every axis named
MESH_PARITY_LAYERS = 4
MESH_REL_TOL = 1e-5           # mesh step vs the same step off the mesh, fp32
RANKS_TRAIN_MESHES = ({"dp": 4}, {"fsdp": 4}, {"tp": 4}, {"sp": 4})
RANKS_PARITY_MESHES = ({"fsdp": 4}, {"tp": 4}, {"sp": 4}, {"dp": 2, "tp": 2})
RANKS_PARITY_BATCH = (4, 128)  # rows split over dp x fsdp, positions over sp
RANKS_REL_TOL = 1e-4           # fp32, sums across ranks in another order
RANKS_TRAIN_STEPS = 3
RANKS_DEADLINE_S = 900
# the moe_mesh phase: GPT2MoEConfig() on a one-rank mesh naming every axis
MOE_MESH_AXES = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, "ep": 1}
# the pipeline phase: GPT-2-124M on a one-rank (dp, pp) mesh
PIPE_AXES = {"dp": 1, "pp": 1}
PIPE_MICRO = 2
PIPE_BATCH = (16, 1024)
PIPE_STEPS = 3                # timed steps after one warm-up step
PIPE_PARITY_BATCH = (4, 128)  # fp32, 4 layers: rows split into 1 or 4 microbatches
PIPE_LR = 3e-4                # PipelineTrainStep's default learning rate
RANKS_MOE_MESHES = ({"ep": 4}, {"dp": 2, "ep": 2})
RANKS_PIPE_MESHES = ({"dp": 2, "pp": 2}, {"pp": 4})
# fault 3 on the cards: 2 heads of 384 over tp = 4 (the einsum attention:
# the kernels take head dims up to 128)
RANKS_FAULT3 = ({"tp": 4}, 2)
TINY_SERVE = {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 96,
              "block_size": 64}
TINY_POOL = {"num_blocks": 24, "block_size": 4}
HEAD48_TRAIN_BATCH = (4, 1024)
PADDED_SHAPES = ((1, 4, 40, 16), (4, 16, 1024, 48))
RUNTIME_TRAIN_STEPS = 3       # the GPU task's steps, the first its warm-up
RUNTIME_LOSS_RTOL = 1e-3      # bf16: its losses vs the train phase's same steps
RUNTIME_OBJECT_NUMEL = 128 * 2**20   # a 256 MiB bf16 tensor
RUNTIME_STOP_S = 30           # the runtime's processes' time to leave
TRAINER_LOSS_RTOL = 1e-3      # bf16: the trainer's losses vs the same steps run without it
DATA_TAIL_BATCHES = 8         # shuffled batches after the train phase's copies
DATA_TAIL_BLOCKS = 4
DATA_TRACED_STEPS = 2         # the trace window: two steps and the next() between them
DATA_CPUS = 5                 # the worker's bundle holds 1; 4 for map and shuffle tasks
BIG_BH_SHAPE = (5462, 12, 16, 64)
RL_CPUS = 6                   # PPO's four runners and its learner's bundle, one to spare
RL_GPUS = 1                   # num_gpus_per_learner of every algorithm in the rllib phase
RL_THRESHOLD = 150.0          # mean return: tests/test_rllib.py:74-80, test_offline_rl.py:137-141
RL_PPO_ITERS = 120
RL_APPO_ITERS = 40
RL_SHORT_ITERS = 3            # IMPALA, DQN, SAC, multi-agent PPO and the checkpoint run
RL_REL_TOL = 1e-5             # a learner's update, card vs CPU: losses, aux, parameters
RL_ABS_FLOOR = 1e-7           # for a value zero up to rounding (PPO's first pi_loss)
MULTINODE_CPUS = 2            # each node's; the card node's two hold the pool's actors
MULTINODE_DEATH_S = 30        # a removed node's time to show DEAD in list_nodes
DAG_BATCH = (4, 512)          # token rows through the two-stage graph and the workflow
DAG_STEPS = 8                 # executes on the main path, each awaited before the next
DAG_IN_FLIGHT = 4             # executes before the first get (depth-1 channels hold 4)
DAG_BUFFER = 16 << 20         # a channel's bytes: the (4, 512, 768) bf16 hidden state is 3 MiB
RL_DP_PPO = dict(num_epochs=2, minibatch_size=127, seed=0)   # odd: each minibatch padded
RL_DP_DQN_ROWS = 254          # DQN rows of the dp check: two rows of pad over four ranks
# the operator phase: a head started by the CLI without the card, and one
# node type of one card that the autoscaler launches for the job's actor
OPERATOR_HEAD_RESOURCES = '{"CPU": 4, "GPU": 0}'
OPERATOR_NODE = {"CPU": 2.0, "GPU": 1.0}
OPERATOR_IDLE_S = 5.0         # the autoscaler's idle timeout for that node
OPERATOR_DEADLINE_S = 600     # a job's time to end; a node's to come or go
OPERATOR_PERF_ROWS = "single_client_tasks_sync,single_client_put_calls,1_1_actor_calls_sync"
LLM_SERIES = ("ray_tpu_llm_tokens_per_s", "ray_tpu_llm_kv_utilization",
              "ray_tpu_llm_batch_size", "ray_tpu_llm_preemptions_total",
              "ray_tpu_llm_prefix_hit_rate", "ray_tpu_llm_spec_acceptance")


def log(msg: str) -> None:
    if LOG:
        print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Time of one call on the card: CUDA events around a window of `iters`
    back-to-back calls, divided by `iters`; the median of three windows.
    A window keeps the card's queue full, so the host's time to launch a
    call is hidden wherever it is shorter than the call itself."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, match: str = "", iters: int = 30, warmup: int = 5,
              attempts: int = 3) -> float:
    """Device time of one call: the time of the kernels whose name holds
    ``match`` (every kernel where it is empty) in one torch.profiler window
    of ``iters`` back-to-back calls, read back with ``read_device_trace``,
    over ``iters``. Beside ``cuda_ms``, whose event window also holds
    whatever the host leaves the card idle between calls, this is the
    card's own time for the work. A window whose trace holds no kernel at
    all (the profiler has now and then delivered no device event for a
    window on the H100) is opened again, up to ``attempts`` windows in
    all."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.train import _telemetry

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            kernel_us = _telemetry.read_device_trace(trace)["kernel_us"]
        if kernel_us:
            break
        log(f"[device_ms] profiler window {attempt} of {attempts} holds no "
            f"device event")
    us = sum(v for name, v in kernel_us.items() if match in name)
    if not us:
        raise AssertionError(f"the profiler window holds no kernel named "
                             f"{match!r}: {sorted(kernel_us)}")
    return us / iters / 1e3


def device_times(case, key: str, fn, match: str = "") -> None:
    """``case[key + "_device"]`` from :func:`device_ms`, and a flag where it
    differs from the window's ``case[key]`` by more than DEVICE_TIME_TOL."""
    case[f"{key}_device"] = dev = device_ms(fn, match)
    if abs(case[key] - dev) > DEVICE_TIME_TOL * dev:
        case.setdefault("window_vs_device", []).append(key)


@contextlib.contextmanager
def forced_block_m(rows: int):
    """Within it, the forward's plan gives ``rows`` query rows per block to
    every fp32 launch (the timed sweep of the fp32 tiles)."""
    from ray_tpu_torch.ops import attention

    plan = attention.fwd_block_m
    attention.fwd_block_m = (lambda bh, t, dtype, sms=attention.H100_SMS:
                             rows if dtype == torch.float32 else plan(bh, t, dtype, sms))
    try:
        yield
    finally:
        attention.fwd_block_m = plan


def reset_counts() -> None:
    """Every kernel's launch counter and the plain-call counter to 0."""
    from ray_tpu_torch.ops import attention

    attention.FLASH_FWD_LAUNCHES = 0
    attention.FLASH_BWD_DQ_LAUNCHES = 0
    attention.FLASH_BWD_DKV_LAUNCHES = 0
    attention.PLAIN_ATTENTION_CALLS = 0


def read_counts():
    """(forward, dq, dk/dv launches, plain attention calls) since the last
    reset."""
    from ray_tpu_torch.ops import attention

    return (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DQ_LAUNCHES,
            attention.FLASH_BWD_DKV_LAUNCHES, attention.PLAIN_ATTENTION_CALLS)


def flight_mark() -> int:
    """The flight recorder's newest sequence number."""
    from ray_tpu_torch._private import flight_recorder

    snap = flight_recorder.get_recorder().snapshot()
    return snap[-1][0] if snap else 0


def flight_events(mark: int, prefix: str):
    """{event: count} of the events named ``prefix``* recorded after
    ``mark``."""
    from ray_tpu_torch._private import flight_recorder

    out = {}
    for e in flight_recorder.dump():
        if e["seq"] > mark and e["event"].startswith(prefix):
            out[e["event"]] = out.get(e["event"], 0) + 1
    return out


def llm_telemetry(tag: str, engine, mark: int, expect_events):
    """The engine's six ray_tpu_llm_* series, read from the port's metric
    table under the engine's deployment tag, and the count of each llm.*
    flight event recorded after ``mark``. Fails if a series this engine
    publishes is unset (the prefix hit rate with the prefix cache on, the
    acceptance with a draft, the preemption counter after a preemption),
    if the tokens/s EMA is not positive, or if an expected event is
    absent: a swallowed telemetry error cannot pass silently."""
    from ray_tpu_torch.util import metrics

    name = engine._tags["deployment"]
    series = {r["name"]: r["value"] for r in metrics.drain_records()
              if r["name"] in LLM_SERIES and r["labels"]["deployment"] == name}
    events = flight_events(mark, "llm.")
    published = ["ray_tpu_llm_tokens_per_s", "ray_tpu_llm_kv_utilization",
                 "ray_tpu_llm_batch_size"]
    if engine.prefix_cache_enabled:
        published.append("ray_tpu_llm_prefix_hit_rate")
    if engine.draft_cache is not None:
        published.append("ray_tpu_llm_spec_acceptance")
    preemptions = engine.scheduler.preemptions_total
    if preemptions:
        published.append("ray_tpu_llm_preemptions_total")
    shown = {n: series.get(n, "unset") for n in LLM_SERIES}
    log(f"[{tag}] series {json.dumps(shown)}; llm.* events {json.dumps(events)}; "
        f"scheduler preemptions {preemptions}")
    missing = [n for n in published if n not in series]
    absent = [e for e in expect_events if not events.get(e)]
    counted = series.get("ray_tpu_llm_preemptions_total", 0)
    if (missing or absent or counted > preemptions
            or series.get("ray_tpu_llm_tokens_per_s", 0) <= 0):
        raise AssertionError(f"{tag}: series unset {missing}, events absent "
                             f"{absent}, series {shown}, events {events}")
    return {"series": shown, "events": events, "preemptions": preemptions}


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes. The
    kernel phases make their inputs on the CPU from fixed seeds, so two
    commits whose digests agree gave bitwise the same outputs."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def norm_err(got, ref) -> float:
    """max |got - ref| / max(max |ref|, 1), in fp32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def attention_flops(shape, per_pair: int) -> int:
    """FLOP of `per_pair` * d per visible (query, key) pair, causal."""
    b, h, t, d = shape
    return per_pair * d * b * h * t * (t + 1) // 2


def rates(ms: float, shape, per_pair: int, bound_ms: float, library_ms: float):
    """Achieved TFLOP/s, share of the bound and ratio to the library call."""
    return {"tflops": attention_flops(shape, per_pair) / (ms * 1e-3) / 1e12,
            "bound_share": bound_ms / ms, "vs_library": ms / library_ms}


def attention_bound(shape, dtype):
    """Least time (ms) for causal attention on these inputs: each of q, k,
    v read once and o, lse written once over HBM bandwidth, against the
    causal products (2 * d multiply-adds per visible (query, key) pair) over
    the peak rate of the inputs' type. Returns (ms, "bytes"|"operations")."""
    b, h, t, d = shape
    bh = b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * t * d * esize + bh * t * 4
    flops = attention_flops(shape, 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(shape, dtype, kernel: str):
    """Least time (ms) for one backward kernel on these inputs. Bytes: q, k,
    v and do read once, lse and delta (fp32) read once, and the kernel's
    outputs written once (dq for "dq"; dk and dv for "dkv"), over HBM
    bandwidth. Operations: per visible (query, key) pair the dq kernel does
    3 products of 2 * d FLOP (q.k, do.v, ds*k), 6 * d, and the dk/dv kernel
    4, 8 * d (q.k, do.v, p*do, ds*q), over the peak rate of the inputs'
    type. Returns (ms, "bytes"|"operations")."""
    b, h, t, d = shape
    bh = b * h
    esize = torch.finfo(dtype).bits // 8
    outputs = 1 if kernel == "dq" else 2
    nbytes = (4 + outputs) * bh * t * d * esize + 2 * bh * t * 4
    flops = attention_flops(shape, 6 if kernel == "dq" else 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------- phases


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    cards = out.stdout.strip().splitlines()
    for line in cards:
        log(f"[device] {line}")
    # one name for the run where every card reads alike (the one-card run)
    card = cards[0] if len(set(cards)) == 1 else " / ".join(cards)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> float:
    from ray_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    libs = _cuda.build()
    dt = time.perf_counter() - t0
    log(f"[build] {sorted(libs)} in {dt:.1f} s")
    # ptxas reports each instance as "Compiling entry function '<mangled>'"
    # followed by its spill and register lines: the fp32 backward kernels
    # are templates on <float, d>, the bf16 tensor-core ones on <d>, the
    # register-tiled fp32 forward on <d, query rows per block>
    entry = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)IfLi(\d+)E")
    entry90 = re.compile(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_sm90_kernel)ILi(\d+)E")
    entry32 = re.compile(r"(flash_fwd_fp32_kernel)ILi(\d+)ELi(\d+)E")
    spills, seen = [], set()
    for name in sorted(libs):
        label = name
        for line in _cuda.build_log(name).splitlines():
            found, found90 = entry.search(line), entry90.search(line)
            found32 = entry32.search(line)
            if found:
                label = "{}<float, {}>".format(*found.groups())
            elif found90:
                label = "{}<bf16, {}>".format(*found90.groups())
            elif found32:
                label = "{}<d={}, rows={}>".format(*found32.groups())
                seen.add(label)
            elif "registers" in line or "spill" in line:
                log(f"[build] {label}: {line.split(':', 1)[-1].strip()}")
                if (("_sm90_" in label or "_fp32_" in label)
                        and re.search(r"[1-9]\d* bytes spill", line)):
                    spills.append(f"{label}: {line.strip()}")
    # the tensor-core designs and the fp32 forward's register tiles are sized
    # to keep their accumulators in registers: a spill is a fault of the
    # build, not a slow path
    if spills:
        raise AssertionError(f"register-tiled kernels spill: {spills}")
    if len(seen) != 9:
        raise AssertionError(f"ptxas reported {len(seen)} fp32 forward instances "
                             f"(expected 3 head dims x 3 tiles): {sorted(seen)}")
    return dt


def phase_kernel(card: str):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    checked = [(shape, dt) for shape in KERNEL_SHAPES
               for dt in (torch.float32, torch.bfloat16)] + [HEADLINE]
    for shape, dtype in checked:
        q, k, v = (torch.randn(shape, generator=gen).to(DEVICE, dtype)
                   for _ in range(3))
        o, lse = attention.flash_causal_attention_fwd(q, k, v)
        o2, lse2 = attention.flash_causal_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        repeatable = torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = attention.plain_causal_attention_fwd(
            q.float(), k.float(), v.float())
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"non-finite kernel output at {shape} {dtype}")
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        b, h, t, _ = shape
        case = {"shape": list(shape), "dtype": dtype_name(dtype),
                "design": DESIGN["flash_attn_fwd"][dtype_name(dtype)],
                "block_m": attention.fwd_block_m(b * h, t, dtype, sms),
                "err_o": err_o, "err_lse": err_lse, "tol": tol,
                "repeatable": repeatable, "digest": digest(o, lse)}
        if dtype == torch.float32:
            # every fp32 tile, not only the plan's: within the tolerance and
            # bitwise repeatable
            case["err_by_block_m"] = {}
            for rows in attention.FP32_BLOCK_MS:
                with forced_block_m(rows):
                    of, lf = attention.flash_causal_attention_fwd(q, k, v)
                    of2, lf2 = attention.flash_causal_attention_fwd(q, k, v)
                torch.cuda.synchronize()
                case["err_by_block_m"][rows] = max(
                    (of - o_ref).abs().max().item(), (lf - lse_ref).abs().max().item())
                repeatable = repeatable and torch.equal(of, of2) and torch.equal(lf, lf2)
                del of, lf, of2, lf2
            case["repeatable"] = repeatable
        if (shape, dtype) in TIMED_FWD:
            bound_ms, bound_by = attention_bound(shape, dtype)
            kernel = lambda: attention.flash_causal_attention_fwd(q, k, v)
            plain = lambda: attention.plain_causal_attention_fwd(q, k, v)
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
            case.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                        library_ms=cuda_ms(library), bound_ms=bound_ms, bound_by=bound_by)
            case.update(rates(case["ms"], shape, 4, bound_ms, case["library_ms"]))
            if b == 1:
                device_times(case, "ms", kernel, "flash_fwd")
                device_times(case, "plain_ms", plain)
                device_times(case, "library_ms", library)
            if dtype == torch.float32:
                # every tile's window and device time: the plan's pick
                # beside the others
                case["grid"] = [b * h, -(-t // case["block_m"])]
                case["ms_by_block_m"], case["device_ms_by_block_m"] = {}, {}
                for rows in attention.FP32_BLOCK_MS:
                    with forced_block_m(rows):
                        case["ms_by_block_m"][rows] = cuda_ms(kernel)
                        case["device_ms_by_block_m"][rows] = device_ms(kernel, "flash_fwd")
        log(f"[kernel] {json.dumps(case)}")
        worst = max([err_o, err_lse] + list(case.get("err_by_block_m", {}).values()))
        if worst > tol or not repeatable:
            raise AssertionError(f"flash_attn_fwd disagrees with its plain "
                                 f"version or is not repeatable: {case}")
        cases.append(case)
        del q, k, v, o, lse, o2, lse2, o_ref, lse_ref
    for c in cases:
        if "ms" in c:
            log(f"[kernel] flash_attn_fwd {c['shape']} {c['dtype']} ({c['design']}): "
                f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, SDPA "
                f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}); {c['tflops']:.1f} TFLOP/s, "
                f"{c['bound_share']:.3f} of the bound, {c['vs_library']:.2f}x SDPA "
                f"on {card}")
        if "ms_device" in c:
            log(f"[kernel]   device time (profiler): kernel {c['ms_device']:.4f} ms, "
                f"plain {c['plain_ms_device']:.4f}, SDPA {c['library_ms_device']:.4f}; "
                f"window and device differ by over {DEVICE_TIME_TOL:.0%} for "
                f"{c.get('window_vs_device', [])}")
        if "ms_by_block_m" in c:
            log(f"[kernel]   fp32 plan: {c['block_m']} query rows a block, grid "
                f"{c['grid']} = {c['grid'][0] * c['grid'][1]} blocks on {sms} SMs; "
                f"ms by rows a block {json.dumps(c['ms_by_block_m'])}, device "
                f"{json.dumps(c['device_ms_by_block_m'])}")
    return cases


def phase_bwd(card: str):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator().manual_seed(1)
    cases = []
    checked = [(shape, dt) for shape in KERNEL_SHAPES
               for dt in (torch.float32, torch.bfloat16)] + [HEADLINE]
    for shape, dtype in checked:
        q, k, v, do = (torch.randn(shape, generator=gen).to(DEVICE, dtype)
                       for _ in range(4))
        o, lse = attention.flash_causal_attention_fwd(q, k, v)
        grads = attention.flash_causal_attention_bwd(q, k, v, o, lse, do)
        # the remat recompute must give what the first forward gave, and two
        # backward runs the same gradients: both bitwise (no atomics)
        o2, lse2 = attention.flash_causal_attention_fwd(q, k, v)
        again = attention.flash_causal_attention_bwd(q, k, v, o2, lse2, do)
        torch.cuda.synchronize()
        repeatable = all(torch.equal(a, b) for a, b in
                         zip((o, lse) + grads, (o2, lse2) + again))
        ref = attention.plain_causal_attention_bwd(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        names = ("dq", "dk", "dv")
        case = {"shape": list(shape), "dtype": dtype_name(dtype),
                "design": {n: DESIGN[n][dtype_name(dtype)] for n in
                           ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")},
                "repeatable": repeatable,
                "digest": {n: digest(g) for n, g in zip(names, grads)},
                "err": {n: norm_err(g, r) for n, g, r in zip(names, grads, ref)},
                "abs_err": {n: (g.float() - r).abs().max().item()
                            for n, g, r in zip(names, grads, ref)},
                "tol": BWD_FP32_TOL if dtype == torch.float32 else BWD_BF16_TOL}
        if dtype == torch.float32:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(attention.plain_causal_attention(*leaves),
                                       leaves, do)
            case["err_vs_autograd"] = {n: norm_err(g, a) for n, g, a in
                                       zip(names, grads, auto)}
        if (shape, dtype) in TIMED_BWD:
            delta = (o.float() * do.float()).sum(dim=-1)
            qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            for kernel, fn in (("dq", attention.launch_bwd_dq),
                               ("dkv", attention.launch_bwd_dkv)):
                bound_ms, bound_by = attention_bwd_bound(shape, dtype, kernel)
                call = lambda fn=fn: fn(q, k, v, do, lse, delta)
                case[kernel] = {"ms": cuda_ms(call), "bound_ms": bound_ms,
                                "bound_by": bound_by}
                if shape[0] == 1:
                    device_times(case[kernel], "ms", call, f"flash_bwd_{kernel}")
            plain = lambda: attention.plain_causal_attention_bwd(q, k, v, o, lse, do)
            library = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                                  retain_graph=True)
            case.update(
                bwd_ms=cuda_ms(lambda: attention.flash_causal_attention_bwd(
                    q, k, v, o, lse, do)),
                plain_ms=cuda_ms(plain), library_ms=cuda_ms(library))
            if shape[0] == 1:
                device_times(case, "plain_ms", plain)
                device_times(case, "library_ms", library)
            for kernel, per_pair in (("dq", 6), ("dkv", 8)):
                case[kernel].update(rates(case[kernel]["ms"], shape, per_pair,
                                          case[kernel]["bound_ms"], case["library_ms"]))
            del delta, qs, ks, vs, sdpa_out
        log(f"[bwd] {json.dumps(case)}")
        finite = all(torch.isfinite(g).all() for g in grads)
        errs = list(case["err"].values()) + list(case.get("err_vs_autograd", {}).values())
        if not finite or not repeatable or max(errs) > case["tol"]:
            raise AssertionError(f"flash_attn_bwd disagrees with its plain "
                                 f"version or is not repeatable: {case}")
        cases.append(case)
        del q, k, v, do, o, lse, o2, lse2, grads, again, ref
    for c in cases:
        if "dq" in c:
            for kernel, name in (("dq", "flash_attn_bwd_dq"), ("dkv", "flash_attn_bwd_dkv")):
                r = c[kernel]
                log(f"[bwd] {name} {c['shape']} {c['dtype']} ({c['design'][name]}): "
                    f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}); "
                    f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound, "
                    f"{r['vs_library']:.2f}x SDPA's whole backward on {card}")
            log(f"[bwd] {c['shape']} {c['dtype']}: whole backward {c['bwd_ms']:.4f} ms, "
                f"plain {c['plain_ms']:.4f}, SDPA backward {c['library_ms']:.4f} "
                f"on {card}")
            if "library_ms_device" in c:
                log(f"[bwd]   device time (profiler): dq {c['dq']['ms_device']:.4f} ms, "
                    f"dk/dv {c['dkv']['ms_device']:.4f}, plain "
                    f"{c['plain_ms_device']:.4f}, SDPA backward "
                    f"{c['library_ms_device']:.4f}; window and device differ by over "
                    f"{DEVICE_TIME_TOL:.0%} for "
                    f"{c.get('window_vs_device', []) + [k for k in ('dq', 'dkv') if c[k].get('window_vs_device')]}")
    torch.cuda.empty_cache()
    return cases


def check_forward(card: str, tag: str, name: str, model, vocab: int) -> None:
    """``model``'s fp32 forward at FORWARD_SHAPE on the card against a CPU
    copy of the same weights (the plain path): logits within LOGIT_TOL and
    one forward kernel launch per layer, no plain attention call."""
    idx = torch.randint(0, vocab, FORWARD_SHAPE,
                        generator=torch.Generator().manual_seed(1))
    cpu_model = copy.deepcopy(model).to("cpu")
    idx_card = idx.to(DEVICE)
    reset_counts()
    with torch.inference_mode():
        logits = model(idx_card)
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()[0], read_counts()[3]
        ms = cuda_ms(lambda: model(idx_card), iters=5, warmup=1)
        ref = cpu_model(idx)
    n_layer = model.config.n_layer
    if launches != n_layer or plain_calls:
        raise AssertionError(f"forward launched the kernel {launches} times, "
                             f"expected {n_layer}, with {plain_calls} plain calls")
    got = logits.cpu()
    err = (got - ref).abs().max().item()
    if got.shape != FORWARD_SHAPE + (vocab,) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits {tuple(got.shape)}")
    log(f"[{tag}] {name} fp32 forward {FORWARD_SHAPE}: {ms:.2f} ms on {card}; "
        f"kernel launches {launches}; max |logit - cpu| {err:.3g}")
    if err > LOGIT_TOL:
        raise AssertionError(f"card logits differ from the CPU plain path by {err}")


def phase_model(card: str) -> None:
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_params

    cfg = GPT2Config.gpt2_124m(dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), device=DEVICE)
    check_forward(card, "model", "gpt2-124m", model, cfg.vocab_size)
    del model
    torch.cuda.empty_cache()


def serve_prompts(vocab: int):
    """The serve phases' 8 prompts (16-600 tokens); requests 3 and 4 share
    their first SHARED_PREFIX tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = [rng.integers(0, vocab, n).tolist() for n in SERVE_PROMPT_LENS]
    prompts[3] = shared + prompts[3][SHARED_PREFIX:]
    prompts[4] = shared + prompts[4][SHARED_PREFIX:]
    return prompts


def drive_engine(engine, prompts, max_tokens: int):
    """Submit every prompt but the fifth, step once (request 3's blocks are
    then indexed), submit the fifth (a prefix-cache hit on request 3's
    first 64 tokens), drain. Returns ({request: tokens}, wall seconds),
    after checking every request ran to its length and the cache is whole
    and empty."""
    from ray_tpu_torch.serve.llm import SamplingParams

    sp = SamplingParams(max_tokens=max_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = {i: engine.submit(p, sp) for i, p in enumerate(prompts) if i != 4}
    engine.step()
    if len(prompts) > 4:
        rids[4] = engine.submit(prompts[4], sp)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outputs = {}
    for i, rid in sorted(rids.items()):
        toks, done, reason = engine.pull(rid)
        if not done or reason != "length" or len(toks) != max_tokens:
            raise AssertionError(f"request {i}: done={done} reason={reason} "
                                 f"tokens={len(toks)}")
        outputs[i] = toks
    for cache in (engine.cache, engine.draft_cache):
        if cache is None:
            continue
        problems = cache.check_integrity()
        if problems:
            raise AssertionError(f"KV cache integrity: {problems}")
        cache.assert_no_leaks()
        if cache.num_used_blocks != 0:
            raise AssertionError("KV blocks still held after drain")
    return outputs, wall


def greedy_gaps(cpu_model, prompts, outputs):
    """Teacher-forced on a plain forward (the CPU's, or the card's einsum
    path): per request, how far each generated token's logit lies below the
    position's max logit."""
    gaps = {}
    with torch.inference_mode():
        dev = next(cpu_model.parameters()).device
        for i, toks in outputs.items():
            ctx = torch.tensor([prompts[i] + toks], device=dev)
            logits = cpu_model(ctx)[0, len(prompts[i]) - 1:-1].float()
            chosen = logits[torch.arange(len(toks), device=dev),
                            torch.tensor(toks, device=dev)]
            gaps[i] = (logits.max(dim=-1).values - chosen).tolist()
    return gaps


def serve_run(card: str, tag: str, adapter):
    """The serving path on ``adapter`` at full width: 8 requests, one
    prefix-cache hit, SERVE_MAX_TOKENS greedy tokens each; the forward
    kernel's launches and no plain attention call, the cache's integrity,
    the engine's series and llm.* events, and every greedy token
    teacher-forced against the CPU plain forward. Returns a dict with the
    launches, plain calls, telemetry, prompts, outputs and the CPU model."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = adapter.cfg
    engine = LLMEngine(adapter, name=tag)
    prompts = serve_prompts(cfg.vocab_size)

    prefills = []   # (tokens, start, ms) per adapter prefill call
    inner = adapter.prefill_ctx

    def timed_prefill(tokens, start, k_ctx, v_ctx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(tokens, start, k_ctx, v_ctx)
        torch.cuda.synchronize()
        prefills.append((len(tokens), start, (time.perf_counter() - t0) * 1e3))
        return out

    adapter.prefill_ctx = timed_prefill
    mark = flight_mark()
    reset_counts()
    outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    launches, plain_calls = read_counts()[0], read_counts()[3]
    del adapter.prefill_ctx

    cold = [p for p in prefills if p[1] == 0]
    hits = [p for p in prefills if p[1] > 0]
    if len(hits) != 1 or hits[0][1] != SHARED_PREFIX:
        raise AssertionError(f"expected one {SHARED_PREFIX}-token prefix hit, "
                             f"got prefills {prefills}")
    if launches < cfg.n_layer * len(cold) or plain_calls:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(cold)} cold prefills x {cfg.n_layer} layers, "
                             f"{plain_calls} plain attention calls")

    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    log(f"[{tag}] {len(prompts)} requests x {SERVE_MAX_TOKENS} tokens in "
        f"{wall:.3f} s: {n_tokens / wall:.1f} tokens/s on {card} "
        f"(fp32, LLMEngine defaults, prefill timings synchronised)")
    for n, start, ms in prefills:
        log(f"[{tag}] prefill {n} tokens at start {start}: {ms:.2f} ms on {card}")
    log(f"[{tag}] flash_attn_fwd launches {launches} for {len(cold)} cold "
        f"prefills x {cfg.n_layer} layers, plain attention calls {plain_calls}; "
        f"stats {engine.stats()}")
    telemetry = llm_telemetry(tag, engine, mark,
                              ("llm.admit", "llm.finish", "llm.prefix_hit"))

    # teacher-forced: every greedy token is the CPU plain forward's argmax
    # to within GREEDY_TOL of the max logit at its position
    cpu_model = copy.deepcopy(adapter.model).to("cpu")
    gaps = greedy_gaps(cpu_model, prompts, outputs)
    worst = max(max(g) for g in gaps.values())
    log(f"[{tag}] teacher-forced: worst greedy gap {worst:.3g} (limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"a greedy token is {worst} below the CPU max logit")
    return {"launches": launches, "plain_calls": plain_calls,
            "tokens_per_s": n_tokens / wall, "telemetry": telemetry,
            "prompts": prompts, "outputs": outputs, "cpu_model": cpu_model,
            "prefills": prefills}


def phase_serve(card: str):
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    adapter = build_adapter("gpt2", seed=0, device=DEVICE)
    cfg = adapter.cfg
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or adapter.dtype != torch.float32:
        raise AssertionError(f"not GPT-2-124M at full width in fp32: {cfg}")
    run = serve_run(card, "serve", adapter)
    del adapter
    torch.cuda.empty_cache()
    # prompts, outputs and the CPU model stay for the runtime phase
    return {k: run[k] for k in ("launches", "plain_calls", "tokens_per_s", "telemetry",
                                "prompts", "outputs", "cpu_model")}


def traced_step(ts, state, batch):
    """One ``ts.step`` inside a device-trace window the step's recorder
    opens (``request_device_trace(1)``), its Chrome trace written to a
    temporary directory and read back. Returns (state, metrics, what
    ``read_device_trace`` says, host ms of the call including the window's
    start, synchronise, stop and export, the trace's MB)."""
    import tempfile

    from ray_tpu_torch.train import _telemetry

    with tempfile.TemporaryDirectory() as trace_dir:
        if not _telemetry.request_device_trace(1, trace_dir):
            raise AssertionError("no current recorder to open a trace window")
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        trace = ts.telemetry.device_trace.last_trace
        if trace is None or not trace.startswith(trace_dir):
            raise AssertionError(f"the trace window wrote no trace: {trace}")
        trace_mb = Path(trace).stat().st_size / 1e6
        read = _telemetry.read_device_trace(trace)
    if not read["kernel_us"]:
        raise AssertionError(f"the trace window holds no kernel: {read}")
    return state, m, read, host_ms, trace_mb


def window_line(read) -> str:
    """The window, its kernels and where the device's idle time sits."""
    ms = lambda us: f"{us / 1e3:.2f}"
    runtime = sorted(read["runtime_us"].items(), key=lambda kv: -kv[1])[:5]
    kernels = sum(read["kernel_us"].values())
    return (f"window {ms(read['window_us'])} ms, kernels {ms(kernels)} ms "
            f"({len(read['kernel_us'])} distinct; with copies and memsets "
            f"{ms(kernels + read['copy_us'])} ms), device busy {ms(read['busy_us'])} ms = "
            f"{read['busy_share']:.3f} of the window (idle before the first "
            f"kernel {ms(read['lead_us'])} ms, between kernels {ms(read['gap_us'])} "
            f"ms, after the last {ms(read['tail_us'])} ms); host CUDA calls "
            + ", ".join(f"{name} {ms(us)} ms x{read['runtime_calls'][name]}"
                        for name, us in runtime))


def train_run(card: str, tag: str, name: str, cfg, batch_shape, steps: int,
              profiled: bool, mesh=None):
    """``TrainStep(cfg, mesh)`` on the card, bf16 compute over fp32 master weights:
    one warm-up step, then ``steps`` timed steps on a repeated batch with a
    falling loss and exactly 2L forward, L dq and L dk/dv launches and no
    plain attention call per step (forward + remat), then (if ``profiled``)
    one step inside the recorder's device-trace window
    (``request_device_trace(1)``), read back from its Chrome trace for the
    largest kernels and the device's busy share; the recorder's slow-step
    flag and its train.step events. Returns the run's numbers."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.train_step import TrainStep
    from ray_tpu_torch.train import _telemetry

    ts = TrainStep(cfg, mesh, device=DEVICE)
    if _telemetry.current_recorder() is not ts.telemetry:
        raise AssertionError("TrainStep did not make its recorder current")
    mark = flight_mark()
    state = ts.init(torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in state["params"].parameters()):
        raise AssertionError("master weights are not fp32")
    model = state["params"]   # whole parameters, where a mesh rank holds a tp shard
    n_params = sum(int(np.prod(_flax.full_shape(model, n, p)))
                   for n, p in model.named_parameters())
    # an MoE token runs top_k of num_experts experts: the active count keeps
    # that share of the expert stacks (wi, wo)
    experts = sum(p.numel() for n, p in state["params"].named_parameters()
                  if n.endswith((".moe.wi", ".moe.wo")))
    moe = getattr(cfg, "moe", None)
    n_active = n_params - experts + (experts * moe.top_k // moe.num_experts
                                     if moe else 0)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, cfg.vocab_size, batch_shape)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    state, m = ts.step(state, batch)     # warm-up, booked as the compile step
    warm_s = time.perf_counter() - t0
    losses, norms, step_ms, counts = [m["loss"].item()], [m["grad_norm"].item()], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    summary = ts.telemetry.summary()
    tokens_per_s = summary["tokens_per_s"]
    # the exact 6N count (every parameter, the untied head included) beside
    # the recorder's estimate 12 L d^2 + V d, over every card of the mesh
    cards = 1 if mesh is None else mesh.size()
    exact_mfu = 6 * n_active * tokens_per_s / (PEAK_FLOPS[torch.bfloat16] * cards)
    log(f"[{tag}] {name} {dtype_name(cfg.dtype)} compute / fp32 params, batch {batch_shape}: "
        f"warm-up {warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms "
        f"on {card}")
    log(f"[{tag}] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches and plain calls per step "
        f"(fwd, dq, dkv, plain) {counts}")
    log(f"[{tag}] recorder: {json.dumps(summary)}; at the median step "
        f"{batch_shape[0] * batch_shape[1] / (statistics.median(step_ms) / 1e3):.0f} "
        f"tokens/s")
    log(f"[{tag}] {n_params} parameters, {n_active} active per token; MFU "
        f"{summary.get('mfu')} by the recorder's 12 L d^2 + V d count, "
        f"{exact_mfu:.6f} by the exact 6N count of active parameters "
        f"({6 * n_active:.4g} FLOP per token) over 989 TFLOP/s x {cards}")
    # ring attention over sp (an einsum, as in JAX) replaces the kernels
    ring = mesh is not None and axis_size(mesh, "sp") > 1
    want = (0, 0, 0, 0) if ring else (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer, 0)
    if any(c != want for c in counts):
        raise AssertionError(f"launches and plain calls per step {counts}, "
                             f"expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    out = {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "losses": losses, "grad_norms": norms, "n_params": n_params,
           "n_active_params": n_active,
           "exact_mfu": exact_mfu,
           "median_tokens_per_s": batch_shape[0] * batch_shape[1]
                                  / (statistics.median(step_ms) / 1e3),
           "launches": [sum(c[i] for c in counts) for i in range(3)],
           "plain_calls": sum(c[3] for c in counts),
           "launches_per_step": list(want[:3]), "summary": summary}

    if profiled:   # where one step's device time goes: the recorder's window
        state, m, read, prof_ms, trace_mb = traced_step(ts, state, batch)
        kernel_us = read["kernel_us"]
        busy_ms = sum(kernel_us.values()) / 1e3
        attn_ms = sum(us for name, us in kernel_us.items() if "flash_" in name) / 1e3
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:16]
        log(f"[{tag}] profiled step (device-trace window, {trace_mb:.1f} MB Chrome "
            f"trace; host {prof_ms:.2f} ms with the window's start, stop and "
            f"export): {window_line(read)}; hand-written attention kernels "
            f"{attn_ms:.2f} ms = {attn_ms / max(busy_ms, 1e-9):.3f} of kernel time "
            f"on {card}")
        for name, us in top:
            log(f"[{tag}]   {us / 1e3:9.3f} ms  {name[:110]}")
        if not kernel_us or (attn_ms <= 0) != ring:
            raise AssertionError(f"the trace window holds no attention kernel: {read}")
        out.update(profiled_step_ms=prof_ms, attention_ms_profiled=attn_ms,
                   kernel_ms_profiled=busy_ms,
                   kernel_and_copy_ms_profiled=busy_ms + read["copy_us"] / 1e3,
                   window_ms=read["window_us"] / 1e3,
                   device_busy_ms=read["busy_us"] / 1e3,
                   device_busy_share=read["busy_share"],
                   idle_lead_ms=read["lead_us"] / 1e3, idle_gap_ms=read["gap_us"] / 1e3,
                   idle_tail_ms=read["tail_us"] / 1e3)
    slow = ts.telemetry.pop_slow_step()
    steps_seen = flight_events(mark, "train.step")
    log(f"[{tag}] slow-step flag: {json.dumps(slow) if slow else 'none raised'} "
        f"(factor {ts.telemetry._slow_factor} x the trailing median); "
        f"train.step events {steps_seen}")
    if steps_seen.get("train.step", 0) != steps + 1 + int(profiled):
        raise AssertionError(f"expected {steps + 1 + int(profiled)} train.step "
                             f"events, got {steps_seen}")
    out.update(slow_step=slow, train_step_events=steps_seen.get("train.step", 0))
    del ts, state, batch, m
    torch.cuda.empty_cache()
    return out


def phase_train(card: str):
    from ray_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.gpt2_124m()   # JAX's default: bf16 compute, remat
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
            != SERVE_WIDTH or cfg.dtype != torch.bfloat16 or not cfg.remat:
        raise AssertionError(f"not GPT-2-124M at full width in bf16: {cfg}")
    train = train_run(card, "train", "gpt2-124m", cfg, TRAIN_BATCH, TRAIN_STEPS,
                      profiled=True)
    train["report_gauges"] = report_gauges("train", "gpt2-124m")
    train["parity"] = train_parity(card, "train", GPT2Config.gpt2_124m(dtype=torch.float32))
    return train


def report_gauges(tag: str, run_name: str) -> dict:
    """The ``telemetry/*`` keys a trainer's report attaches from the current
    recorder (``auto_report_metrics``), published with
    ``publish_report_summary`` and read back from the port's metric table:
    each of the seven keys (all set on the card) gives its
    ``ray_tpu_train_*`` gauge under ``{"run": run_name}``, equal to it."""
    from ray_tpu_torch.train import _telemetry
    from ray_tpu_torch.train._report_gauges import _REPORT_GAUGES
    from ray_tpu_torch.util import metrics

    report = _telemetry.auto_report_metrics()
    _telemetry.publish_report_summary(report, run_name=run_name)
    got = {r["name"]: r["value"] for r in metrics.drain_records()
           if r["kind"] == "gauge" and r["labels"] == {"run": run_name}}
    want = {name: float(report[key]) for key, name in _REPORT_GAUGES.items()
            if key in report}
    log(f"[{tag}] publish_report_summary, read back under run={run_name!r}: "
        f"{json.dumps(got)}")
    if len(want) != len(_REPORT_GAUGES) or got != want:
        raise AssertionError(f"report gauges {got}, expected {want} from {report}")
    return got


def first_steps_probe(card: str, tag: str, cfg):
    """A fresh ``TrainStep(cfg)`` on the card: the warm-up step untraced,
    then the two next steps each inside its own device-trace window. The
    timed runs' first step after the warm-up is an outlier for Llama; these
    windows show what that step does on the host and the card beside a
    steady one. No step here is one of the timed steps."""
    from ray_tpu_torch.parallel.train_step import TrainStep

    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    warm_ms = (time.perf_counter() - t0) * 1e3
    out = {"warm_up_ms": warm_ms}
    for name in ("first_after_warm_up", "second_after_warm_up"):
        state, m, read, host_ms, _ = traced_step(ts, state, batch)
        log(f"[{tag}] probe, {name.replace('_', ' ')} step (fresh TrainStep, "
            f"warm-up {warm_ms:.1f} ms untraced): {window_line(read)} on {card}")
        out[name] = {k: read[k] for k in ("window_us", "busy_us", "busy_share",
                                          "lead_us", "gap_us", "tail_us",
                                          "runtime_us", "runtime_calls")}
        out[name]["kernel_ms"] = sum(read["kernel_us"].values()) / 1e3
    del ts, state, batch, m
    torch.cuda.empty_cache()
    return out


def train_parity(card: str, tag: str, cfg):
    """One fp32 step at full width on the card and on the CPU plain path
    from the same weights (drawn on the CPU from one seed)."""
    from ray_tpu_torch.parallel.train_step import TrainStep

    card_ts = TrainStep(cfg, device=DEVICE, telemetry=False)
    host_ts = TrainStep(cfg, device="cpu", telemetry=False)
    card_state = card_ts.init(torch.Generator().manual_seed(1))
    host_state = host_ts.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    idx = rng.integers(0, cfg.vocab_size, PARITY_BATCH)
    raw = {"idx": idx, "targets": np.roll(idx, -1, axis=1)}
    cb, hb = card_ts.shard_batch(raw), host_ts.shard_batch(raw)

    loss_c, grads_c = card_ts.loss_and_grads(card_state, cb)
    loss_h, grads_h = host_ts.loss_and_grads(host_state, hb)
    grad_err = max(((grads_c[n].cpu() - g).norm() / g.norm()).item()
                   for n, g in grads_h.items() if g.norm() > 0)
    card_state, mc = card_ts.step(card_state, cb)
    host_state, mh = host_ts.step(host_state, hb)
    rel = lambda a, b: abs(a - b) / abs(b)
    out = {"loss_card": loss_c.item(), "loss_cpu": loss_h.item(),
           "loss_rel_err": rel(loss_c.item(), loss_h.item()),
           "grad_norm_rel_err": rel(mc["grad_norm"].item(), mh["grad_norm"].item()),
           "step_loss_rel_err": rel(mc["loss"].item(), mh["loss"].item()),
           "grad_rel_err": grad_err,
           "param_abs_err": max((p.detach().cpu() - q.detach()).abs().max().item()
                                for p, q in zip(card_state["params"].parameters(),
                                                host_state["params"].parameters()))}
    log(f"[{tag}] fp32 step {PARITY_BATCH}, card vs CPU plain path: {json.dumps(out)}")
    param_tol = 2 * card_ts.learning_rate + 1e-6
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"], out["step_loss_rel_err"],
            out["grad_rel_err"]) > TRAIN_REL_TOL or out["param_abs_err"] > param_tol):
        raise AssertionError(f"card train step differs from the CPU plain path: {out}")
    del card_ts, card_state, host_ts, host_state
    torch.cuda.empty_cache()
    return out


def llama_loss_fn_check(card: str, cfg) -> dict:
    """``models/llama.py``'s ``loss_fn`` on its ``forward``'s fp32 logits
    against the loss ``TrainStep.step`` reports for the same weights and
    batch on the card (TRAIN_REL_TOL)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.train_step import TrainStep

    ts = TrainStep(cfg, device=DEVICE, telemetry=False)
    state = ts.init(torch.Generator().manual_seed(1))
    idx = np.random.default_rng(1).integers(0, cfg.vocab_size, PARITY_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    model = state["params"]
    with torch.no_grad():
        direct = llama.loss_fn(llama.forward(cfg, model, batch["idx"]),
                               batch["targets"]).item()
    out = {"loss_fn": direct}
    state, m = ts.step(state, batch)
    out["step_loss"] = m["loss"].item()
    out["rel_err"] = abs(direct - out["step_loss"]) / abs(out["step_loss"])
    log(f"[llama] loss_fn on the fp32 forward's logits vs TrainStep's loss, "
        f"{PARITY_BATCH} on {card}: {json.dumps(out)}")
    if out["rel_err"] > TRAIN_REL_TOL:
        raise AssertionError(f"llama.loss_fn against TrainStep's loss: {out}")
    del ts, state, batch, model
    torch.cuda.empty_cache()
    return out


def phase_llama(card: str):
    """Llama-160M at full width (GQA: k/v repeated from 4 to 12 heads
    before the kernels): forward against the CPU, serving, training, and
    one fp32 step against the CPU."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    cfg = LlamaConfig.llama_160m(dtype=torch.float32)
    width = (cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.n_embd, cfg.mlp_dim,
             cfg.vocab_size, cfg.block_size)
    if width != LLAMA_WIDTH:
        raise AssertionError(f"not Llama-160M at full width: {width}")
    model = init_params(cfg, torch.Generator().manual_seed(0), device=DEVICE)
    check_forward(card, "llama", "llama-160m", model, cfg.vocab_size)
    del model

    adapter = build_adapter("llama-160m", seed=0, device=DEVICE)
    if adapter.dtype != torch.float32 or adapter.cfg != cfg:
        raise AssertionError(f"not Llama-160M in fp32: {adapter.cfg}")
    serve = serve_run(card, "llama", adapter)
    del adapter
    torch.cuda.empty_cache()

    train = train_run(card, "llama", "llama-160m", LlamaConfig.llama_160m(),
                      TRAIN_BATCH, TRAIN_STEPS, profiled=True)
    train["first_steps"] = first_steps_probe(card, "llama", LlamaConfig.llama_160m())
    train["parity"] = train_parity(card, "llama", cfg)
    train["loss_fn"] = llama_loss_fn_check(card, cfg)
    return {"serve_launches": serve["launches"], "serve_plain_calls": serve["plain_calls"],
            "serve_tokens_per_s": serve["tokens_per_s"],
            "serve_telemetry": serve["telemetry"], "train": train,
            "prompts": serve["prompts"], "outputs": serve["outputs"],
            "cpu_model": serve["cpu_model"]}


def phase_spec(card: str, prompts, serve_outputs, cpu_model):
    """Speculative decoding on the card: the Llama-160M target answers the
    serve phases' prompts without a draft and with each of two drafts (the
    target's own weights from its seed; llama-tiny at vocabulary 32000).
    Every speculative stream must equal the plain one; where one differs,
    its first differing token and every token after must lie within
    GREEDY_TOL of the CPU plain forward's max logit (a near tie). Each
    engine's series and llm.* events are read as in the serve phase."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    target = build_adapter("llama-160m", seed=0, device=DEVICE)
    drafts = {"same-seed llama-160m": build_adapter("llama-160m", seed=0, device=DEVICE),
              "llama-tiny": build_adapter(
                  "llama-tiny", {"vocab_size": 32000, "block_size": 1024}, seed=0,
                  device=DEVICE)}
    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    reset_counts()
    mark = flight_mark()
    engine = LLMEngine(target, name="spec-plain")
    plain, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    # the plain engine again, without the serve phase's prefill timing: the
    # same streams, or (checked against the CPU) near-greedy ones
    replay_equal = plain == serve_outputs
    if not replay_equal:
        gaps = greedy_gaps(cpu_model, prompts, plain)
        if max(max(g) for g in gaps.values()) > GREEDY_TOL:
            raise AssertionError("the plain replay leaves the greedy stream")
    log(f"[spec] plain: {n_tokens / wall:.1f} tokens/s on {card}; streams equal to "
        f"the llama serve phase's: {replay_equal}")
    results = {"plain_tokens_per_s": n_tokens / wall, "plain_replay_equal": replay_equal,
               "plain_telemetry": llm_telemetry(
                   "spec", engine, mark, ("llm.admit", "llm.finish", "llm.prefix_hit"))}
    for name, draft in drafts.items():
        engine = LLMEngine(target, draft_adapter=draft, spec_k=SPEC_K,
                           name=f"spec-{name.split()[0]}")
        mark = flight_mark()
        outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
        differ = {i: next(c for c, (a, b) in enumerate(zip(toks, plain[i])) if a != b)
                  for i, toks in outputs.items() if toks != plain[i]}
        worst = 0.0
        if differ:   # each differing stream must be near-greedy from there on
            gaps = greedy_gaps(cpu_model, prompts, {i: outputs[i] for i in differ})
            worst = max(max(g[differ[i]:]) for i, g in gaps.items())
        stats = engine.stats()
        res = {"acceptance": engine.spec_acceptance(),
               "rounds": stats["spec_rounds_total"], "steps": stats["steps_total"],
               "tokens_per_s": n_tokens / wall, "streams_equal": len(prompts) - len(differ),
               "first_differences": differ, "worst_gap_after_difference": worst}
        log(f"[spec] draft {name}, k = {SPEC_K}: {json.dumps(res)} on {card}")
        res["telemetry"] = llm_telemetry(
            "spec", engine, mark,
            ("llm.admit", "llm.finish", "llm.prefix_hit", "llm.spec_verify"))
        accept = res["telemetry"]["series"]["ray_tpu_llm_spec_acceptance"]
        if abs(accept - engine.spec_acceptance()) > 1e-12:
            raise AssertionError(f"acceptance series {accept} != the engine's "
                                 f"{engine.spec_acceptance()}")
        if worst > GREEDY_TOL:
            raise AssertionError(f"speculative stream with draft {name} leaves the "
                                 f"plain stream by more than a near tie: {res}")
        results[name] = res
        if name == "same-seed llama-160m":   # the serve_deploy phase's reference
            results["same_seed_outputs"] = outputs
    results["launches"], results["plain_calls"] = read_counts()[0], read_counts()[3]
    if results["launches"] == 0 or results["plain_calls"]:
        raise AssertionError(f"the spec runs launched {results['launches']} forward "
                             f"kernels, with {results['plain_calls']} plain calls")
    if results["same-seed llama-160m"]["acceptance"] < 0.5:
        raise AssertionError(f"a draft with the target's own weights accepted "
                             f"{results['same-seed llama-160m']['acceptance']}")
    del target, drafts
    torch.cuda.empty_cache()
    return results


def routing_of(model, idx):
    """Per MoE block, the dispatch mask (B, S, E, C) its router gives the
    block's input in a forward of ``idx`` on ``model``'s device."""
    from ray_tpu_torch.models.gpt2_moe import MoEBlock
    from ray_tpu_torch.ops.moe import top_k_routing

    seen = []
    hooks = [blk.moe.register_forward_pre_hook(lambda mod, args: seen.append(
        (mod, args[0].detach()))) for blk in model.h if isinstance(blk, MoEBlock)]
    with torch.no_grad():
        model(idx)
    for h in hooks:
        h.remove()
    out = []
    for mod, x in seen:
        probs = torch.softmax(mod.router(x.float()), dim=-1)
        dispatch, _ = top_k_routing(probs, mod.moe.top_k, mod.capacity(x.shape[1]))
        out.append((dispatch.cpu(), probs.cpu()))
    return out


def serve_against_cpu(card: str, tag: str, model: str, config, prompts, engine_kw,
                      expect_events=("llm.admit", "llm.finish")):
    """``model`` from the zoo (``config`` its model_config) serves
    ``prompts`` (4 requests) x 16 greedy tokens on the card and on the CPU
    from one seed, through
    engines built with ``engine_kw``. Where a card stream differs, every
    token from the first difference on must lie within GREEDY_TOL of the
    CPU adapter's max logit (a near tie). Returns (streams equal, worst
    gap, the card run's (forward, dq, dk/dv launches, plain calls), its
    telemetry as :func:`llm_telemetry` reads it, expecting
    ``expect_events``)."""
    from ray_tpu_torch.serve.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    streams, adapters = {}, {}
    for key, dev in (("card", DEVICE), ("cpu", "cpu")):
        adapters[key] = build_adapter(model, config, seed=0, device=dev)
        engine = LLMEngine(adapters[key], name=f"{tag}-{key}", **engine_kw)
        mark = flight_mark()
        reset_counts()
        rids = [engine.submit(p, SamplingParams(max_tokens=16)) for p in prompts]
        engine.run_until_drained()
        streams[key] = [engine.pull(r)[0] for r in rids]
        engine.cache.assert_no_leaks()
        if any(len(t) != 16 for t in streams[key]):
            raise AssertionError(f"{model} on {dev}: {streams[key]}")
        if key == "card":
            counts = read_counts()
            log(f"[{tag}] {model} on the card: (fwd, dq, dkv) launches and plain "
                f"attention calls {counts}; engine stats {engine.stats()}")
            telemetry = llm_telemetry(tag, engine, mark, expect_events)
    worst = 0.0
    for p, card_toks, cpu_toks in zip(prompts, streams["card"], streams["cpu"]):
        if card_toks == cpu_toks:
            continue
        first = next(c for c, (a, b) in enumerate(zip(card_toks, cpu_toks)) if a != b)
        for c in range(first, len(card_toks)):
            logits = adapters["cpu"].prefill(np.asarray(p + card_toks[:c]))[0]
            worst = max(worst, (logits.max() - logits[card_toks[c]]).item())
    equal = sum(a == b for a, b in zip(streams["card"], streams["cpu"]))
    log(f"[{tag}] {model} serving {len(prompts)} requests x 16 tokens: {equal} of "
        f"{len(prompts)} card streams equal the CPU's; worst gap after a difference "
        f"{worst:.3g} (limit {GREEDY_TOL})")
    if worst > GREEDY_TOL:
        raise AssertionError(f"{model} card streams leave the CPU's: {streams}")
    return {"streams_equal": equal, "worst_gap": worst, "counts": list(counts),
            "telemetry": telemetry}


def phase_moe(card: str):
    """GPT-2-MoE (GPT2MoEConfig(): GPT-2-124M widths, 8 experts, top-2,
    an MoE block every 2nd layer) trains on the card; one fp32 step against
    the CPU, dispatch masks first; gpt2-moe-tiny serves against the CPU."""
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig, init_params

    cfg = GPT2MoEConfig()
    if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.moe.num_experts,
            cfg.moe.top_k, cfg.moe_every) != MOE_WIDTH or cfg.dtype != torch.bfloat16:
        raise AssertionError(f"not the JAX package's default GPT-2-MoE: {cfg}")
    train = train_run(card, "moe", "gpt2-moe", cfg, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS,
                      profiled=False)

    # fp32 step against the CPU: the routing first, so that a flip from a
    # near tie shows as such and not as a gradient error
    fp32 = GPT2MoEConfig(dtype=torch.float32)
    model = init_params(fp32, torch.Generator().manual_seed(1), device=DEVICE)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, fp32.vocab_size, PARITY_BATCH))
    card_routes = routing_of(model, idx.to(DEVICE))
    host_routes = routing_of(copy.deepcopy(model).to("cpu"), idx)
    flips = []
    for layer, ((dc, pc), (dh, ph)) in enumerate(zip(card_routes, host_routes)):
        rows = (dc != dh).flatten(2).any(-1).nonzero().tolist()
        for b, s in rows:
            top = ph[b, s].sort(descending=True).values
            flips.append({"layer": layer, "token": [b, s],
                          "gap_k_k1": (top[cfg.moe.top_k - 1] - top[cfg.moe.top_k]).item()})
    log(f"[moe] fp32 routing {PARITY_BATCH}, card vs CPU: "
        f"{sum(d.sum().item() for d, _ in card_routes):.0f} dispatched slots over "
        f"{len(card_routes)} MoE blocks, flips {flips}")
    if flips:
        raise AssertionError(f"dispatch masks differ between card and CPU (gaps "
                             f"between the k-th and next expert's probability): {flips}")
    del model
    train["parity"] = train_parity(card, "moe", fp32)

    # gpt2-moe-tiny serves 4 requests (dropless routing) on the card and on
    # the CPU from one seed; the streams must be equal
    prompts = [np.random.default_rng(i).integers(0, 512, n).tolist()
               for i, n in enumerate((5, 17, 40, 90))]
    served = serve_against_cpu(card, "moe", "gpt2-moe-tiny", None, prompts, {})
    if served["counts"][3]:
        raise AssertionError(f"gpt2-moe-tiny made plain attention calls: {served}")
    train["serve_streams_equal"] = served["streams_equal"]
    torch.cuda.empty_cache()
    return train


def check_attention(q, k, v, do):
    """The public forward and backward on the card (the kernels, padded or
    chunked as the shape needs) against the plain version in fp32 on the
    same inputs: the (forward, dq, dk/dv launches, plain calls) they took,
    the errors (o and lse absolute, dq/dk/dv normalised) and a digest."""
    from ray_tpu_torch.ops import attention

    reset_counts()
    o, lse = attention.flash_causal_attention_fwd(q, k, v)
    grads = attention.flash_causal_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    counts = read_counts()
    o_ref, lse_ref = attention.plain_causal_attention_fwd(q.float(), k.float(), v.float())
    ref = attention.plain_causal_attention_bwd(q.float(), k.float(), v.float(),
                                               o.float(), lse, do.float())
    fp32 = q.dtype == torch.float32
    out = {"shape": list(q.shape), "dtype": dtype_name(q.dtype),
           "kernel_head_dim": attention.kernel_head_dim(q.shape[-1]),
           "counts": list(counts),
           "err_o": (o.float() - o_ref).abs().max().item(),
           "err_lse": (lse - lse_ref).abs().max().item(),
           "err": {n: norm_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, ref)},
           "tol": [FP32_TOL if fp32 else BF16_TOL, BWD_FP32_TOL if fp32 else BWD_BF16_TOL],
           "digest": digest(o, lse, *grads)}
    if (out["err_o"] > out["tol"][0] or out["err_lse"] > out["tol"][0]
            or max(out["err"].values()) > out["tol"][1]):
        raise AssertionError(f"attention kernels disagree with the plain version: {out}")
    return out, o, lse


def phase_head_dims(card: str):
    """Head dims the kernels are not built for (16, 48) run on them,
    zero-padded to the next kernel size, with no plain call, on a serving
    path, a training step and alone against the plain version; a B * H
    above the grid's 65535 runs the kernels in chunks."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.train_step import TrainStep

    # gpt2-tiny at head dim 16, 4 requests through a pool small enough to
    # preempt, against the CPU
    prompts = [np.random.default_rng(i).integers(0, 96, n).tolist()
               for i, n in enumerate((5, 17, 40, 30))]
    served = serve_against_cpu(card, "head_dims", "gpt2-tiny", TINY_SERVE, prompts,
                               TINY_POOL, ("llm.admit", "llm.finish", "llm.preempt"))
    if served["counts"][0] <= 0 or served["counts"][1:] != [0, 0, 0]:
        raise AssertionError(f"head dim 16 should take only forward launches: {served}")
    if not served["telemetry"]["preemptions"]:
        raise AssertionError("the small pool preempted nothing")

    # one GPT2Config(n_head=16) bf16 step (head dim 48) at full width
    cfg = GPT2Config.gpt2_124m(n_head=16)
    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, HEAD48_TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    reset_counts()
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    log(f"[head_dims] GPT2Config(n_head=16) bf16 step, head dim "
        f"{cfg.n_embd // cfg.n_head}, batch {HEAD48_TRAIN_BATCH}: loss {loss:.4f}, "
        f"grad_norm {norm:.4f}, {step_ms:.1f} ms (first call) on {card}; (fwd, dq, "
        f"dkv) launches and plain calls {counts}")
    per_step = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer, 0)
    if counts != per_step or not np.isfinite([loss, norm]).all():
        raise AssertionError(f"head dim 48 step: counts {counts} (want {per_step}), "
                             f"loss {loss}, grad_norm {norm}")
    del ts, state, batch, m
    torch.cuda.empty_cache()
    parity = train_parity(card, "head_dims", GPT2Config.gpt2_124m(
        n_head=16, dtype=torch.float32))

    # the padded kernels alone at the shapes of the two paths above
    padded = []
    for shape in PADDED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(DEVICE).manual_seed(shape[-1])
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                           for _ in range(4))
            case, _, _ = check_attention(q, k, v, do)
            log(f"[head_dims] padded {json.dumps(case)}")
            if case["counts"] != [1, 1, 1, 0]:
                raise AssertionError(f"padded head dim left the kernels: {case}")
            padded.append(case)
            del q, k, v, do

    # B * H = 65544: two chunks of each kernel, against the plain version
    gen = torch.Generator(DEVICE).manual_seed(2)
    q, k, v, do = (torch.randn(BIG_BH_SHAPE, generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    big, o, lse = check_attention(q, k, v, do)
    # the last batch element is the second chunk: alone it must give the same bits
    o_last, lse_last = attention.flash_causal_attention_fwd(q[-1:], k[-1:], v[-1:])
    big["second_chunk_bitwise"] = torch.equal(o_last, o[-1:]) and torch.equal(
        lse_last, lse[-1:])
    log(f"[head_dims] B * H = {BIG_BH_SHAPE[0] * BIG_BH_SHAPE[1]}: {json.dumps(big)}")
    if big["counts"] != [2, 2, 2, 0] or not big["second_chunk_bitwise"]:
        raise AssertionError(f"chunked kernels: {big}")
    del q, k, v, do, o, lse, o_last, lse_last
    torch.cuda.empty_cache()
    return {"head_dim_16_serve": served, "head_dim_48_train": {
        "counts": list(counts), "loss": loss, "grad_norm": norm, "step_ms": step_ms,
        "fp32_parity": parity}, "padded": padded, "big_bh": big}


def mesh_parity(card: str, name: str, cfg, mesh, batch_shape=PARITY_BATCH,
                rel_tol: float = MESH_REL_TOL, tag: str = "mesh"):
    """One fp32 step of ``cfg`` on ``mesh`` and off it, on the card, from the
    same weights and batch: loss and grad_norm to ``rel_tol`` relative,
    every parameter (gathered from the mesh) to 2 * lr."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.parallel.train_step import TrainStep

    plain = TrainStep(cfg, device=DEVICE, telemetry=False)
    meshed = TrainStep(cfg, mesh, device=DEVICE, telemetry=False)
    a = plain.init(torch.Generator().manual_seed(2))
    b = meshed.init(torch.Generator().manual_seed(2))
    idx = np.random.default_rng(2).integers(0, cfg.vocab_size, batch_shape)
    raw = {"idx": idx, "targets": np.roll(idx, -1, axis=1)}
    a, ma = plain.step(a, plain.shard_batch(raw))
    b, mb = meshed.step(b, meshed.shard_batch(raw))
    rel = lambda x, y: abs(x.item() - y.item()) / abs(y.item())
    model = b["params"]
    out = {"loss_rel_err": rel(mb["loss"], ma["loss"]),
           "grad_norm_rel_err": rel(mb["grad_norm"], ma["grad_norm"]),
           "param_abs_err": max(
               (_flax.gather_full(model, n, q, meshed.tp, meshed.ep)
                - p.detach().cpu()).abs().max().item()
               for (n, q), p in zip(model.named_parameters(), a["params"].parameters())),
           "loss": mb["loss"].item(), "grad_norm": mb["grad_norm"].item()}
    log(f"[{tag}] fp32 step {batch_shape}, {name} ({cfg.n_layer} layers), on the mesh "
        f"vs off it on {card}: {json.dumps(out)}")
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"]) > rel_tol
            or out["param_abs_err"] > 2 * plain.learning_rate):
        raise AssertionError(f"the mesh step differs from the one-device step: {out}")
    del plain, meshed, a, b, model
    torch.cuda.empty_cache()
    return out


def phase_mesh(card: str, train):
    """``TrainStep`` on a world-size-1 mesh over NCCL: GPT-2-124M training
    as in phase 7, its step times beside phase 7's median, and the fp32
    mesh step against the one-device step for GPT-2 and Llama widths."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_AXES, device=DEVICE)
    backend, world = dist.get_backend(), dist.get_world_size()
    run = train_run(card, "mesh", "gpt2-124m", GPT2Config.gpt2_124m(), TRAIN_BATCH,
                    TRAIN_STEPS, profiled=True, mesh=mesh)
    log(f"[mesh] {backend}, world size {world}, mesh {MESH_AXES}: steps "
        f"{[round(x, 2) for x in run['step_ms']]} ms, median "
        f"{run['median_step_ms']:.2f} ms beside the one-device train phase's median "
        f"{train['median_step_ms']:.2f} ms (x{run['median_step_ms'] / train['median_step_ms']:.4f}) "
        f"on {card}")
    run["backend"], run["world_size"] = backend, world
    run["one_device_median_step_ms"] = train["median_step_ms"]
    fp32 = dict(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    run["parity"] = {
        "gpt2-124m": mesh_parity(card, "gpt2-124m", GPT2Config.gpt2_124m(**fp32), mesh),
        "llama-160m": mesh_parity(card, "llama-160m", LlamaConfig.llama_160m(**fp32), mesh)}
    return run


def phase_moe_mesh(card: str, moe):
    """GPT2MoEConfig() through ``TrainStep`` on a one-rank mesh that names
    every axis of it, ep included (the same process group as phase 12):
    24 / 12 / 12 launches and no plain call a step, step times beside the
    moe phase's median, one step traced; then
    one fp32 step of a 4-layer GPT2MoEConfig on the mesh against the same
    step off it."""
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MOE_MESH_AXES, device=DEVICE)
    run = train_run(card, "moe_mesh", "gpt2-moe", GPT2MoEConfig(), MOE_TRAIN_BATCH,
                    MOE_TRAIN_STEPS, profiled=True, mesh=mesh)
    log(f"[moe_mesh] mesh {MOE_MESH_AXES}: steps {[round(x, 2) for x in run['step_ms']]} "
        f"ms, median {run['median_step_ms']:.2f} ms beside the moe phase's median "
        f"{moe['median_step_ms']:.2f} ms (x{run['median_step_ms'] / moe['median_step_ms']:.4f}) "
        f"on {card}")
    run["one_device_median_step_ms"] = moe["median_step_ms"]
    run["parity"] = mesh_parity(
        card, "gpt2-moe", GPT2MoEConfig(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32),
        mesh, tag="moe_mesh")
    return run


def pipeline_run(card: str, tag: str, name: str, cfg, mesh, batch_shape, steps: int,
                 micro=None):
    """``PipelineTrainStep(cfg, mesh)`` on the card, bf16 compute over fp32
    master weights: one warm-up step, then ``steps`` timed steps (host
    clock around a step and a synchronise) on a repeated batch with a
    falling loss; launches per step must be the schedule's: each of this
    stage's blocks runs the forward kernel twice per microbatch (forward
    and remat) and each backward kernel once per microbatch, with no plain
    attention call. Returns the run's numbers."""
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.pipeline import PipelineTrainStep

    pts = PipelineTrainStep(cfg, mesh, num_microbatches=micro, device=DEVICE)
    state = pts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, batch_shape)
    batch = pts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = pts.step(state, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses, norms, step_ms, counts = [m["loss"].item()], [m["grad_norm"].item()], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        state, m = pts.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    blocks = cfg.n_layer // axis_size(mesh, "pp")
    want = (2 * blocks * pts.num_micro, blocks * pts.num_micro, blocks * pts.num_micro, 0)
    median = statistics.median(step_ms)
    log(f"[{tag}] {name} {dtype_name(cfg.dtype)} compute / fp32 params, batch {batch_shape}, "
        f"{pts.num_micro} microbatches, {blocks} blocks on this stage: warm-up "
        f"{warm_s:.2f} s, then steps {[round(x, 2) for x in step_ms]} ms (median "
        f"{median:.2f} ms, {batch_shape[0] * batch_shape[1] / (median / 1e3):.0f} tokens/s "
        f"over the mesh), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    log(f"[{tag}] loss {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, launches and plain calls per step "
        f"(fwd, dq, dkv, plain) {counts}, the schedule's {want}")
    if any(c != want for c in counts):
        raise AssertionError(f"launches and plain calls per step {counts}, expected {want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    out = {"step_ms": step_ms, "median_step_ms": median, "losses": losses,
           "grad_norms": norms, "num_microbatches": pts.num_micro,
           "median_tokens_per_s": batch_shape[0] * batch_shape[1] / (median / 1e3),
           "launches": [sum(c[i] for c in counts) for i in range(3)],
           "plain_calls": sum(c[3] for c in counts), "launches_per_step": list(want[:3]),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    del pts, state, batch, m
    torch.cuda.empty_cache()
    return out


def pipeline_step(cfg, mesh, micro: int, device, batch_shape=PIPE_PARITY_BATCH):
    """One fp32 ``PipelineTrainStep`` step from the weights of seed 2 on a
    batch of seed 2: (loss, grad_norm, the whole parameters on the CPU)."""
    from ray_tpu_torch.parallel.pipeline import PipelineTrainStep, full_state

    pts = PipelineTrainStep(cfg, mesh, num_microbatches=micro, learning_rate=PIPE_LR,
                            device=device)
    state = pts.init(torch.Generator().manual_seed(2))
    idx = np.random.default_rng(2).integers(0, cfg.vocab_size, batch_shape)
    state, m = pts.step(state, pts.shard_batch({"idx": idx,
                                                "targets": np.roll(idx, -1, axis=1)}))
    return m["loss"].item(), m["grad_norm"].item(), full_state(pts, state)["params"]


def pipeline_compare(tag: str, what: str, got, ref, rel_tol: float):
    """``got`` against ``ref`` (each from :func:`pipeline_step`): loss and
    grad_norm within ``rel_tol`` relative, parameters within 2 * lr."""
    out = {"loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
           "grad_norm_rel_err": abs(got[1] - ref[1]) / abs(ref[1]),
           "param_abs_err": max((got[2][k] - ref[2][k]).abs().max().item() for k in ref[2]),
           "loss": got[0], "grad_norm": got[1]}
    log(f"[{tag}] fp32 pipeline step {PIPE_PARITY_BATCH}, {what}: {json.dumps(out)}")
    if (max(out["loss_rel_err"], out["grad_norm_rel_err"]) > rel_tol
            or out["param_abs_err"] > 2 * PIPE_LR):
        raise AssertionError(f"{what}: the pipeline steps differ: {out}")
    return out


def phase_pipeline(card: str):
    """``PipelineTrainStep`` on a one-rank (dp, pp) mesh: GPT-2-124M at
    (16, 1024) bf16 over 2 microbatches, launches against the schedule's
    count; then two fp32 steps of a 4-layer GPT-2-124M-width model: 1
    microbatch against 4 on the card (the schedule must not change the
    numbers), and the card against the port's own CPU step from the same
    weights."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(PIPE_AXES, device=DEVICE)
    run = pipeline_run(card, "pipeline", "gpt2-124m", GPT2Config.gpt2_124m(), mesh,
                       PIPE_BATCH, PIPE_STEPS, PIPE_MICRO)
    fp32 = GPT2Config.gpt2_124m(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    one = pipeline_step(fp32, mesh, 1, DEVICE)
    four = pipeline_step(fp32, mesh, 4, DEVICE)
    host = pipeline_step(fp32, make_mesh(PIPE_AXES, device="cpu"), 1, "cpu")
    run["parity"] = {
        "micro_4_vs_1": pipeline_compare("pipeline", f"4 microbatches vs 1 on {card}",
                                         four, one, MESH_REL_TOL),
        "card_vs_cpu": pipeline_compare("pipeline", f"{card} vs the CPU, 1 microbatch",
                                        one, host, MESH_REL_TOL)}
    torch.cuda.empty_cache()
    return run


# ------------------------------------------------------------------ runtime
# The workers of the port's runtime are forks of its fork server, which
# never imports torch: CUDA is first touched in the worker, after its
# lease's CUDA_VISIBLE_DEVICES is set. The classes and functions below go
# to them by value (cloudpickle) with this module's globals.


def _lease_probe():
    """A GPU lease's first seconds: the worker's torch import and CUDA
    context, on the card the lease names."""
    import os

    import ray_tpu_torch

    t0 = time.perf_counter()
    import torch as _torch

    t1 = time.perf_counter()
    _torch.ones(1, device=DEVICE).sum().item()
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "accelerator_ids": ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
            "device_count": _torch.cuda.device_count(),
            "import_torch_s": t1 - t0, "cuda_context_s": time.perf_counter() - t1}


class RuntimeServer:
    """A GPU actor: GPT-2-124M at full width, fp32, on its leased card,
    serving through LLMEngine."""

    def __init__(self):
        from ray_tpu_torch.serve.llm.adapters import build_adapter

        t0 = time.perf_counter()
        self.adapter = build_adapter("gpt2", seed=0, device=DEVICE)
        cfg = self.adapter.cfg
        if (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size) \
                != SERVE_WIDTH or self.adapter.dtype != torch.float32:
            raise AssertionError(f"not GPT-2-124M at full width in fp32: {cfg}")
        self.build_s = time.perf_counter() - t0

    def serve(self, prompts):
        import os

        import ray_tpu_torch
        from ray_tpu_torch.serve.llm import LLMEngine

        engine = LLMEngine(self.adapter, name="runtime_serve")
        reset_counts()
        outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
        launches, plain_calls = read_counts()[0], read_counts()[3]
        return {"outputs": outputs, "wall_s": wall, "launches": launches,
                "plain_calls": plain_calls, "build_s": self.build_s,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "accelerator_ids":
                    ray_tpu_torch.get_runtime_context().get_accelerator_ids(),
                "device_count": torch.cuda.device_count()}


def _train_task(steps: int):
    """GPT-2-124M through TrainStep on the leased card, bf16, from the
    train phase's seed and batch: the losses, each step's counts and ms."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.train_step import TrainStep

    cfg = GPT2Config.gpt2_124m()
    ts = TrainStep(cfg, device=DEVICE)
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    losses, counts, step_ms = [], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(read_counts())
        losses.append(m["loss"].item())
    return {"losses": losses, "counts": counts, "step_ms": step_ms,
            "n_layer": cfg.n_layer}


def _object_task(t):
    """Receives the driver's CUDA tensor (as a CPU tensor) and sends it
    back from its own card."""
    if t.device.type != "cpu":
        raise AssertionError(f"a stored tensor arrived on {t.device}")
    return t.to(DEVICE)


def script_children():
    """Every process below this one but multiprocessing's resource tracker,
    which ``--ranks`` starts with its spawn context's queue and which holds
    that queue's semaphores until this process exits: killed with the
    runtime's processes, it made the exit print ``resource_tracker: process
    died unexpectedly`` and a KeyError for each semaphore."""
    import psutil

    def tracker(proc) -> bool:
        try:
            return "multiprocessing.resource_tracker" in " ".join(proc.cmdline())
        except psutil.Error:
            return False

    return [p for p in psutil.Process().children(recursive=True) if not tracker(p)]


def stop_runtime(rt) -> None:
    """``rt.shutdown()``, then wait for every process the runtime started:
    actor workers (forks of the fork server, in sessions of their own)
    leave a moment after their raylet, and the script must not end before
    them. Any still alive after RUNTIME_STOP_S is killed."""
    import psutil

    procs = script_children()
    rt.shutdown()
    gone, alive = psutil.wait_procs(procs, timeout=RUNTIME_STOP_S)
    for proc in alive:
        proc.kill()
    psutil.wait_procs(alive, timeout=10)
    log(f"[runtime] shutdown: {len(gone)} of the runtime's {len(procs)} "
        f"processes left within {RUNTIME_STOP_S} s, {len(alive)} killed")


def _bitwise_equal(a, b) -> bool:
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(width), b.contiguous().view(width)))


def phase_runtime(card: str, serve, train):
    """The port's runtime on the card: ``init`` autodetects it; a
    ``num_gpus=1`` actor serves the serve phase's prompts through the
    forward kernel with streams equal to the in-process engine's (or
    leaving them only at a near tie of the CPU plain forward); a
    ``num_gpus=1`` task trains GPT-2-124M for RUNTIME_TRAIN_STEPS steps at
    24 / 12 / 12 launches a step with losses within RUNTIME_LOSS_RTOL of the
    train phase's same steps; a 256 MiB bf16 CUDA tensor goes through
    ``put`` and a GPU task and comes back bitwise. Every process the runtime
    started is stopped before the phase returns or raises."""
    import ray_tpu_torch as rt

    # the same import in a fresh interpreter, beside the lease's
    fresh = subprocess.run(
        [sys.executable, "-c", "import time; t0 = time.perf_counter(); "
         "import torch; print(time.perf_counter() - t0)"],
        capture_output=True, text=True, check=True, timeout=300)
    fresh_import_s = float(fresh.stdout.split()[-1])
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        start_s = time.perf_counter() - t0
        gpus = rt.cluster_resources().get("GPU", 0)
        if gpus != torch.cuda.device_count():
            raise AssertionError(f"the runtime detected {gpus} GPUs, torch sees "
                                 f"{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        probe = rt.get(rt.remote(num_gpus=1)(_lease_probe).remote(), timeout=300)
        lease_s = time.perf_counter() - t0
        log(f"[runtime] cluster start {start_s:.2f} s; first GPU lease "
            f"{lease_s:.2f} s (of which the worker's torch import "
            f"{probe['import_torch_s']:.2f} s and its CUDA context "
            f"{probe['cuda_context_s']:.2f} s; import torch in a fresh "
            f"interpreter {fresh_import_s:.2f} s): {json.dumps(probe)}")

        # the actor's first run pays its process's first launches (kernel
        # libraries, cuBLAS, the allocator): timed apart from the second,
        # which is the one compared with the in-process serve phase
        server = rt.remote(num_gpus=1)(RuntimeServer).remote()
        cold = rt.get(server.serve.remote(serve["prompts"]), timeout=600)
        got = rt.get(server.serve.remote(serve["prompts"]), timeout=600)
        rt.kill(server)
        if cold.pop("outputs") != got["outputs"] or cold["launches"] != got["launches"]:
            raise AssertionError(f"the actor's two runs differ: {cold}, {got}")
        ids = got["accelerator_ids"]["GPU"]
        if got["visible"] is None or ids != got["visible"].split(",") \
                or len(ids) != 1 or got["device_count"] != 1:
            raise AssertionError(f"the actor's lease: {got['visible']}, {ids}, "
                                 f"{got['device_count']} cards")
        outputs = got.pop("outputs")
        differ = {i: next(c for c, (a, b) in enumerate(zip(toks, serve["outputs"][i]))
                          if a != b)
                  for i, toks in outputs.items() if toks != serve["outputs"][i]}
        worst = 0.0
        if differ:   # each differing stream must be near-greedy from there on
            gaps = greedy_gaps(serve["cpu_model"], serve["prompts"],
                               {i: outputs[i] for i in differ})
            worst = max(max(g[differ[i]:]) for i, g in gaps.items())
        n_tokens = SERVE_MAX_TOKENS * len(serve["prompts"])
        got.update(tokens_per_s=n_tokens / got["wall_s"], first_differences=differ,
                   worst_gap_after_difference=worst,
                   cold_tokens_per_s=n_tokens / cold["wall_s"])
        log(f"[runtime] actor: {len(outputs)} requests x {SERVE_MAX_TOKENS} tokens at "
            f"{got['tokens_per_s']:.1f} tokens/s (its first run "
            f"{got['cold_tokens_per_s']:.1f}; in-process serve phase "
            f"{serve['tokens_per_s']:.1f}; the serve phase synchronises around "
            f"each prefill) on {card}; streams equal {len(outputs) - len(differ)}"
            f"/{len(outputs)}; {json.dumps(got)}")
        if got["launches"] == 0 or got["plain_calls"] or worst > GREEDY_TOL:
            raise AssertionError(f"the actor's serving path: {got}")

        run = rt.get(rt.remote(num_gpus=1)(_train_task).remote(RUNTIME_TRAIN_STEPS),
                     timeout=600)
        want = (2 * run["n_layer"], run["n_layer"], run["n_layer"], 0)
        ref = train["losses"][:RUNTIME_TRAIN_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref)]
        log(f"[runtime] train task: losses {run['losses']} vs the train phase's "
            f"{ref}: largest relative difference {max(rel):.3g} (limit "
            f"{RUNTIME_LOSS_RTOL}); step ms {[round(x, 2) for x in run['step_ms']]} "
            f"(first includes the warm-up) vs the train phase's median "
            f"{train['median_step_ms']:.2f} on {card}; counts per step "
            f"(fwd, dq, dkv, plain) {run['counts']}")
        if any(tuple(c) != want for c in run["counts"]) or max(rel) > RUNTIME_LOSS_RTOL:
            raise AssertionError(f"the train task: {run}, expected {want} a step")

        x = torch.randn(RUNTIME_OBJECT_NUMEL, device=DEVICE).to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = x.cpu()
        copy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host_ref = rt.put(host)          # the same bytes, from the host
        put_host_ms = (time.perf_counter() - t0) * 1e3
        del host_ref, host
        t0 = time.perf_counter()
        ref = rt.put(x)
        put_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back_ref = rt.remote(num_gpus=1)(_object_task).remote(ref)
        rt.wait([back_ref], timeout=300)
        task_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = rt.get(back_ref, timeout=300)
        get_ms = (time.perf_counter() - t0) * 1e3
        mib = x.numel() * x.element_size() / 2**20
        equal = back.device.type == "cpu" and _bitwise_equal(back, x.cpu())
        log(f"[runtime] objects: put of a {mib:.0f} MiB bf16 CUDA tensor "
            f"{put_ms:.1f} ms (its device-to-host copy alone {copy_ms:.1f} ms; "
            f"a put of the same bytes from the host, the first into the "
            f"store, {put_host_ms:.1f} ms), the GPU task that gets it and returns it from its "
            f"card {task_ms:.1f} ms, get of the result {get_ms:.1f} ms on {card}; "
            f"bitwise equal on the CPU: {equal}")
        if not equal:
            raise AssertionError("the tensor did not come back bitwise")
    finally:
        stop_runtime(rt)
    return {"start_s": start_s, "first_gpu_lease_s": lease_s,
            "lease_import_torch_s": probe["import_torch_s"],
            "lease_cuda_context_s": probe["cuda_context_s"],
            "fresh_import_torch_s": fresh_import_s,
            "actor_build_s": got["build_s"],
            "serve_launches": got["launches"], "serve_plain_calls": got["plain_calls"],
            "serve_tokens_per_s": got["tokens_per_s"],
            "serve_tokens_per_s_first_run": got["cold_tokens_per_s"],
            "serve_tokens_per_s_in_process": serve["tokens_per_s"],
            "serve_streams_equal": len(outputs) - len(differ),
            "train_losses": run["losses"], "train_loss_max_rel_diff": max(rel),
            "train_step_ms": run["step_ms"],
            "train_median_step_ms_in_process": train["median_step_ms"],
            "train_launches": [sum(c[i] for c in run["counts"]) for i in range(3)],
            "train_plain_calls": sum(c[3] for c in run["counts"]),
            "object_mib": mib, "put_ms": put_ms, "copy_to_host_ms": copy_ms,
            "put_from_host_ms": put_host_ms, "task_ms": task_ms, "get_ms": get_ms}


def _deploy_probe_class():
    """A subclass of the port's ``LLMReplica``, defined here and sent to the
    replica by value: ``llm.deploy`` binds it where it binds ``LLMReplica``
    (patched in the driver only), so the deployment's options and arguments
    stay ``deploy``'s own. It times its construction and reads the launch
    counters in the process where the engine runs."""
    from ray_tpu_torch.serve.llm.engine import LLMReplica

    class DeployProbe(LLMReplica):
        def __init__(self, *args, **kwargs):
            import os

            import psutil

            entered = time.time()
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            torch.cuda.synchronize()
            self._start = {
                "process_start": psutil.Process().create_time(),
                "init_entered": entered, "build_s": time.perf_counter() - t0,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "device": str(self.engine.adapter.device), "pid": os.getpid()}
            reset_counts()

        async def probe(self, reset: bool = False) -> dict:
            """This replica's start, and its (forward, plain) counts since
            the last reset; ``reset`` zeroes them after the read."""
            counts = read_counts()
            if reset:
                reset_counts()
            return {**self._start, "launches": counts[0], "plain_calls": counts[3]}

    return DeployProbe


def deploy_probed(llm, probe_cls, **kwargs):
    """``llm.deploy(**kwargs)`` with ``probe_cls`` bound in ``LLMReplica``'s
    place; returns (handle, seconds the call took)."""
    real = llm.LLMReplica
    llm.LLMReplica = probe_cls
    try:
        t0 = time.perf_counter()
        handle = llm.deploy(**kwargs)
        return handle, time.perf_counter() - t0
    finally:
        llm.LLMReplica = real


def stream_all(llm, app: str, prompts, max_tokens: int):
    """Every prompt as a concurrent ``llm.stream``, one thread each: the
    tokens, each stream's time to its first token, and the wall time."""
    import threading

    out, ttft, errors = {}, {}, []

    def one(i, prompt):
        try:
            t0 = time.perf_counter()
            stream = llm.stream(prompt, app_name=app, max_tokens=max_tokens)
            toks = [next(stream)]
            ttft[i] = time.perf_counter() - t0
            toks.extend(stream)
            out[i] = toks
        except BaseException as e:  # noqa: BLE001 — raised below, in the driver
            errors.append(f"stream {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or len(out) != len(prompts):
        raise AssertionError(f"streams through {app}: {errors or sorted(out)}")
    bad = {i: len(t) for i, t in out.items() if len(t) != max_tokens}
    if bad:
        raise AssertionError(f"streams through {app} ended early: {bad}")
    return dict(sorted(out.items())), ttft, wall


def near_greedy(cpu_model, prompts, outputs, ref):
    """Streams of ``outputs`` that differ from ``ref``: {request: first
    differing position}, and the worst CPU greedy gap from there on (each
    must be a near tie, within GREEDY_TOL)."""
    differ = {i: next(c for c, (a, b) in enumerate(zip(toks, ref[i])) if a != b)
              for i, toks in outputs.items() if toks != ref[i]}
    worst = 0.0
    if differ:
        gaps = greedy_gaps(cpu_model, prompts, {i: outputs[i] for i in differ})
        worst = max(max(g[differ[i]:]) for i, g in gaps.items())
    return differ, worst


def handle_close_check(card: str, rt_serve, h, cpu_model, prompt, tokens) -> dict:
    """``DeploymentHandle.close`` as the reference does it
    (``ray_tpu/serve/_handle.py:307``): the handle leaves the process's
    long-poll (its replica set loses one holder) and joins it no more; a
    call on it still routes, from the set it last saw, and answers as
    before; a new handle subscribes and serves a prompt the prefix cache
    has not seen through the forward kernel, with no plain attention call
    and every greedy token within GREEDY_TOL of the CPU plain forward's max
    logit."""
    from ray_tpu_torch.serve._handle import _replica_set

    rs = _replica_set(h.deployment_name)
    held = rs.holders
    h.close()
    released = held - rs.holders
    again = h.remote(prompt, max_tokens=SERVE_MAX_TOKENS).result(timeout=300)["tokens"]
    out = {"holders_before_close": held, "released": released,
           "closed_call_equal": again == tokens,
           "closed_call_resubscribed": rs.holders != held - 1}
    fresh = rt_serve.get_app_handle("gpt2")
    fresh.probe.remote(reset=True).result(timeout=60)
    new_prompt = np.random.default_rng(1).integers(
        0, SERVE_WIDTH[3], SERVE_PROMPT_LENS[3]).tolist()
    toks = fresh.remote(new_prompt, max_tokens=SERVE_MAX_TOKENS).result(timeout=300)["tokens"]
    counts = fresh.probe.remote().result(timeout=60)
    out.update(new_handle_subscribed=fresh._sub is rs, tokens=len(toks),
               launches=counts["launches"], plain_calls=counts["plain_calls"],
               worst_greedy_gap=max(greedy_gaps(cpu_model, {0: new_prompt}, {0: toks})[0]))
    log(f"[serve_deploy] after close: {json.dumps(out)} on {card}")
    if (released != 1 or not out["closed_call_equal"] or out["closed_call_resubscribed"]
            or not out["new_handle_subscribed"] or len(toks) != SERVE_MAX_TOKENS
            or counts["launches"] == 0 or counts["plain_calls"]
            or out["worst_greedy_gap"] > GREEDY_TOL):
        raise AssertionError(f"DeploymentHandle.close: {out}")
    return out


def phase_serve_deploy(card: str, serve, runtime, spec, llama_prompts, llama_cpu):
    """The serve deployment on the card: ``llm.deploy(model="gpt2")`` starts
    one replica on one leased card (its start split into the lease, the
    worker's start with its torch import, and the model build); the serve
    phase's 8 prompts go through it as concurrent ``llm.stream`` streams, a
    warm run and a timed one, plus one ``generate`` and one handle call;
    every stream equals the in-process serve phase's (or leaves it only at
    a near tie of the CPU plain forward); inside the replica the forward
    kernel launches and no plain attention call runs; then its handle is
    closed (``handle_close_check``). Then
    ``llm.deploy(model="llama-160m", draft_model="llama-160m", spec_k=4)``:
    its streams equal the spec phase's same-seed run (near-tie rule) and
    its acceptance equals that run's. Every process the runtime started is
    stopped before the phase returns or raises."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch.serve import llm

    probe_cls = _deploy_probe_class()
    prompts = serve["prompts"]
    n_tokens = SERVE_MAX_TOKENS * len(prompts)
    rt.init(num_cpus=4)
    try:
        t_deploy = time.time()
        h, deploy_s = deploy_probed(llm, probe_cls, model="gpt2", seed=0,
                                    app_name="gpt2", route_prefix="/gpt2")
        start = h.probe.remote().result(timeout=60)
        if (start["visible"] is None or len(start["visible"].split(",")) != 1
                or start["device_count"] != 1 or start["device"] != "cuda:0"):
            raise AssertionError(f"the replica's lease: {start}")
        # the constructor runs after the lease, the worker's start and the
        # unpickle of the class (which imports torch and the port's engine)
        split = {"deploy_s": deploy_s,
                 "lease_worker_and_import_s": start["init_entered"] - t_deploy,
                 "worker_age_at_constructor_s":
                     start["init_entered"] - start["process_start"],
                 "model_build_s": start["build_s"],
                 "ready_check_s": t_deploy + deploy_s - start["init_entered"]
                 - start["build_s"]}
        log(f"[serve_deploy] replica start {deploy_s:.2f} s (llm.deploy until "
            f"ready): the lease, the worker's start and its import of torch and "
            f"LLMReplica {split['lease_worker_and_import_s']:.2f} s (the worker "
            f"process was {split['worker_age_at_constructor_s']:.2f} s old at the "
            f"constructor; import torch alone in a fresh interpreter "
            f"{runtime['fresh_import_torch_s']:.2f} s), model build and CUDA "
            f"context {split['model_build_s']:.2f} s, serve.run's ready check "
            f"{split['ready_check_s']:.2f} s; card {start['visible']} of its "
            f"lease on {card}")

        # counts from 0 over both runs: the timed run's prompts all hit the
        # prefix cache the warm run filled, so its cold prefills (the
        # kernel's launches) are the warm run's
        h.probe.remote(reset=True).result(timeout=60)
        warm, warm_ttft, warm_wall = stream_all(llm, "gpt2", prompts, SERVE_MAX_TOKENS)
        warm_counts = h.probe.remote().result(timeout=60)
        outputs, ttft, wall = stream_all(llm, "gpt2", prompts, SERVE_MAX_TOKENS)
        counts = h.probe.remote().result(timeout=60)
        gen = llm.generate(prompts[0], app_name="gpt2", max_tokens=SERVE_MAX_TOKENS)
        call = h.remote(prompts[0], max_tokens=SERVE_MAX_TOKENS).result(timeout=300)
        stats = h.stats.remote().result(timeout=60)
        differ, worst = near_greedy(serve["cpu_model"], prompts, outputs, serve["outputs"])
        res = {**split, "launches": counts["launches"], "plain_calls": counts["plain_calls"],
               "warm_launches": warm_counts["launches"],
               "tokens_per_s": n_tokens / wall, "warm_tokens_per_s": n_tokens / warm_wall,
               "ttft_s": [ttft[i] for i in sorted(ttft)],
               "warm_ttft_s": [warm_ttft[i] for i in sorted(warm_ttft)],
               "streams_equal": len(outputs) - len(differ), "first_differences": differ,
               "worst_gap_after_difference": worst, "warm_equal": warm == outputs,
               "generate_equal": gen == outputs[0],
               "call_equal": call["tokens"] == outputs[0], "stats": stats}
        log(f"[serve_deploy] {len(prompts)} concurrent llm.stream streams x "
            f"{SERVE_MAX_TOKENS} tokens at {res['tokens_per_s']:.1f} tokens/s (warm-up "
            f"run {res['warm_tokens_per_s']:.1f}; in-process serve phase "
            f"{serve['tokens_per_s']:.1f}; runtime actor "
            f"{runtime['serve_tokens_per_s']:.1f}) on {card}; time to first token "
            f"per stream {[round(t, 3) for t in res['ttft_s']]} s (warm-up run "
            f"{[round(t, 3) for t in res['warm_ttft_s']]}); streams equal "
            f"{res['streams_equal']}/{len(prompts)}; flash_attn_fwd launches in the "
            f"replica {counts['launches']} over both runs ({warm_counts['launches']} in "
            f"the warm-up run), plain attention calls {counts['plain_calls']}; prefix "
            f"hit rate {stats.get('prefix_hit_rate')}")
        if (counts["launches"] == 0 or counts["plain_calls"] or worst > GREEDY_TOL
                or not (res["warm_equal"] and res["generate_equal"] and res["call_equal"])):
            raise AssertionError(f"the deployment's serving path: {res}")
        res["after_close"] = handle_close_check(card, rt_serve, h, serve["cpu_model"],
                                                prompts[0], outputs[0])
        rt_serve.delete("gpt2")

        ref = spec["same_seed_outputs"]
        ref_accept = spec["same-seed llama-160m"]["acceptance"]
        h, deploy_s = deploy_probed(llm, probe_cls, model="llama-160m", seed=0,
                                    draft_model="llama-160m", spec_k=SPEC_K,
                                    app_name="spec", route_prefix="/spec")
        h.probe.remote(reset=True).result(timeout=60)
        spec_out, spec_ttft, spec_wall = stream_all(llm, "spec", llama_prompts,
                                                    SERVE_MAX_TOKENS)
        counts = h.probe.remote().result(timeout=60)
        stats = h.stats.remote().result(timeout=60)
        differ, worst = near_greedy(llama_cpu, llama_prompts, spec_out, ref)
        res["spec"] = {"deploy_s": deploy_s, "launches": counts["launches"],
                       "plain_calls": counts["plain_calls"],
                       "tokens_per_s": SERVE_MAX_TOKENS * len(llama_prompts) / spec_wall,
                       "ttft_s": [spec_ttft[i] for i in sorted(spec_ttft)],
                       "acceptance": stats["spec_acceptance"],
                       "spec_phase_acceptance": ref_accept,
                       "streams_equal": len(spec_out) - len(differ),
                       "first_differences": differ, "worst_gap_after_difference": worst,
                       "stats": stats}
        log(f"[serve_deploy] llama-160m with a same-seed llama-160m draft, k = {SPEC_K}: "
            f"acceptance {stats['spec_acceptance']} (spec phase {ref_accept:.4f}), "
            f"streams equal {res['spec']['streams_equal']}/{len(llama_prompts)}, "
            f"{res['spec']['tokens_per_s']:.1f} tokens/s on {card}; launches "
            f"{counts['launches']}, plain calls {counts['plain_calls']}")
        if (counts["launches"] == 0 or counts["plain_calls"] or worst > GREEDY_TOL
                or (not differ and stats["spec_acceptance"] != round(ref_accept, 4))):
            raise AssertionError(f"the speculative deployment: {res['spec']}")
    finally:
        try:
            rt_serve.shutdown()
        finally:
            stop_runtime(rt)
    return res


# --------------------------------------------------------- 17. the trainer


def _trainer_class():
    """``TorchTrainer`` with two timing marks, defined here and sent to the
    trial actor by value: when the trial actor starts the run
    (``_fit_direct``) and when its worker group is placed
    (``_on_group_start``, after the placement group is reserved and the
    workers are submitted). Each mark is a line of JSON appended to
    ``marks_path``; nothing else changes."""
    from ray_tpu_torch.train.torch import TorchTrainer

    class MarkedTrainer(TorchTrainer):
        marks_path = ""

        def _mark(self, label: str) -> None:
            import os

            with open(self.marks_path, "a") as f:
                f.write(json.dumps({"label": label, "t": time.time(),
                                    "pid": os.getpid()}) + "\n")

        def _fit_direct(self, report_callback=None):
            self._mark("trial_start")
            return TorchTrainer._fit_direct(self, report_callback)

        def _on_group_start(self, group):
            self._mark("group_placed")
            TorchTrainer._on_group_start(self, group)

    return MarkedTrainer


def _worker_start():
    """A train worker's first seconds, timed from inside its loop: the loop's
    start (wall clock), its ``import torch``, and the CUDA context on the
    card ``train.torch.get_device()`` names."""
    import os

    started = time.time()
    t0 = time.perf_counter()
    import torch as _torch

    import_s = time.perf_counter() - t0
    import ray_tpu_torch
    from ray_tpu_torch import train as rtrain

    device = rtrain.torch.get_device()
    t0 = time.perf_counter()
    _torch.ones(1, device=device).sum().item()
    return device, {
        "loop_start": started, "import_torch_s": import_s,
        "cuda_context_s": time.perf_counter() - t0,
        "device": str(device), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "accelerator_ids": ray_tpu_torch.get_runtime_context().get_accelerator_ids()["GPU"],
        "device_count": _torch.cuda.device_count()}


def _trainer_loop(config):
    """The loop of the trainer phase, run by the one ``use_gpu`` worker:
    GPT-2-124M at full width from the train phase's seed and batch, bf16
    compute over fp32 master weights; one warm-up step and TRAIN_STEPS timed
    steps, each reported with its loss, ms, launches and plain calls; one
    step in a device-trace window; then a checkpoint of the model's state
    dict with its digest. It reaches no torch through its globals, so the
    trial actor that unpickles it never imports torch."""
    import os
    import shutil
    import tempfile

    device, start = _worker_start()
    t0 = time.perf_counter()
    import torch as _torch

    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.train_step import TrainStep
    from ray_tpu_torch.train import _telemetry

    cfg = GPT2Config.gpt2_124m()
    ts = TrainStep(cfg, device=device)
    state = ts.init(_torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, cfg.vocab_size, TRAIN_BATCH)
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    start["build_s"] = time.perf_counter() - t0
    for step in range(1 + TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        ms = (time.perf_counter() - t0) * 1e3
        rtrain.report({**start, "step": step, "n_layer": cfg.n_layer,
                       "loss": m["loss"].item(),
                       "grad_norm": m["grad_norm"].item(), "step_ms": ms,
                       "counts": list(read_counts()), "reported_at": time.time()})
    if not _telemetry.request_device_trace(1, config["trace_dir"]):
        raise AssertionError("no current recorder to open a trace window")
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    traced_ms = (time.perf_counter() - t0) * 1e3
    params = {k: v.detach().cpu() for k, v in state["params"].state_dict().items()}
    ckpt = tempfile.mkdtemp(prefix="trainer_ckpt_")
    try:
        _torch.save(params, os.path.join(ckpt, "model.pt"))
        rtrain.report({"step": "checkpoint", "digest": _params_digest(params),
                       "traced_step_ms": traced_ms,
                       "trace": ts.telemetry.device_trace.last_trace},
                      checkpoint=rtrain.Checkpoint(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _params_digest(params) -> str:
    """sha256 of a state dict of CPU tensors: each name and its bytes, in
    name order."""
    sha = hashlib.sha256()
    for k in sorted(params):
        sha.update(k.encode())
        sha.update(params[k].numpy().tobytes())
    return sha.hexdigest()


def phase_trainer(card: str, train):
    """``TorchTrainer(...).fit()`` on the card (a new ``init(num_cpus=4)``):
    a one-trial Tune run, its trial actor, a placement group of one
    ``{"GPU": 1, "CPU": 1}`` bundle, one worker on its leased card running
    :func:`_trainer_loop`. Checks: 24 / 12 / 12 launches and no plain call
    a step in the worker, CUDA_VISIBLE_DEVICES equal to its accelerator
    ids, losses within TRAINER_LOSS_RTOL of the train phase's same steps
    and falling, the Result's checkpoint loaded on the CPU bitwise equal to
    the worker's digest, the ray_tpu_train_* gauges in the GCS from the
    driver, and the worker's trace window registered with the GCS (as the
    dashboard lists it, ``profiling.list_registered``). Prints the
    start-up split and the step times beside the train phase's."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.train import RunConfig, ScalingConfig

    scratch = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    rt.init(num_cpus=4)
    try:
        trainer = _trainer_class()(
            _trainer_loop,
            train_loop_config={"trace_dir": str(Path(scratch) / "trace")},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=scratch, name="trainer"))
        trainer.marks_path = str(Path(scratch) / "marks.jsonl")
        fit_start = time.time()
        result = trainer.fit()
        fit_s = time.time() - fit_start
        marks = {m["label"]: m["t"] for m in map(json.loads, open(trainer.marks_path))}
        gcs = worker_mod.global_worker.gcs
        worker_mod.global_worker.flush_user_metrics_sync()
        gauges = {r["name"]: r["value"] for r in gcs.call(
            "GetUserMetrics", {"prefix": "ray_tpu_train_"})["records"]
            if r["kind"] == "gauge" and r["labels"].get("run") == "trainer"}
        traces = profiling.list_registered(gcs, "device_trace")
        history = result.metrics_history
        steps = [h for h in history if isinstance(h.get("step"), int)]
        last = history[-1]
        digest = _params_digest(torch.load(Path(result.checkpoint.path) / "model.pt",
                                           map_location="cpu"))
    finally:
        stop_runtime(rt)
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)

    first = steps[0]
    want = [2 * first["n_layer"], first["n_layer"], first["n_layer"], 0]
    losses = [s["loss"] for s in steps]
    ref = train["losses"][:len(losses)]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    step_ms = [s["step_ms"] for s in steps]
    timed = step_ms[1:]
    startup = {
        "trial_actor_s": marks["trial_start"] - fit_start,
        "placement_group_s": marks["group_placed"] - marks["trial_start"],
        "worker_lease_s": first["loop_start"] - marks["group_placed"],
        "worker_import_torch_s": first["import_torch_s"],
        "worker_cuda_context_s": first["cuda_context_s"],
        "build_s": first["build_s"], "warm_up_step_s": first["step_ms"] / 1e3,
        "fit_to_first_report_s": first["reported_at"] - fit_start}
    res = {"startup": startup, "fit_s": fit_s, "losses": losses,
           "train_phase_losses": ref, "loss_max_rel_diff": max(rel),
           "step_ms": step_ms, "median_step_ms": statistics.median(timed),
           "train_phase_median_step_ms": train["median_step_ms"],
           "sum_step_ms": sum(step_ms) + last["traced_step_ms"],
           "counts": [s["counts"] for s in steps],
           "launches": [sum(s["counts"][i] for s in steps[1:]) for i in range(3)],
           "plain_calls": sum(s["counts"][3] for s in steps),
           "visible": first["visible"], "accelerator_ids": first["accelerator_ids"],
           "device": first["device"], "device_count": first["device_count"],
           "checkpoint_digest_equal": digest == last["digest"], "gauges": gauges,
           "trace_listed": any(t["path"] == str(Path(scratch) / "trace") for t in traces),
           "reports": len(history)}
    log(f"[trainer] TorchTrainer.fit() of GPT-2-124M (bf16, batch {TRAIN_BATCH}) on one "
        f"leased card: {fit_s:.2f} s in all against {res['sum_step_ms'] / 1e3:.2f} s "
        f"of steps; until the first report {startup['fit_to_first_report_s']:.2f} s: "
        f"trial actor {startup['trial_actor_s']:.2f} s, placement group and worker "
        f"submission {startup['placement_group_s']:.2f} s, the worker's lease "
        f"{startup['worker_lease_s']:.2f} s, its import torch "
        f"{startup['worker_import_torch_s']:.2f} s, its CUDA context "
        f"{startup['worker_cuda_context_s']:.2f} s, the port's imports and the "
        f"model's build {startup['build_s']:.2f} s, the warm-up step "
        f"{startup['warm_up_step_s']:.2f} s on {card}")
    log(f"[trainer] steps {[round(x, 2) for x in step_ms]} ms (the first the warm-up), "
        f"median {res['median_step_ms']:.2f} ms beside the train phase's "
        f"{train['median_step_ms']:.2f}; losses {[round(x, 4) for x in losses]} vs the "
        f"train phase's {[round(x, 4) for x in ref]}: largest relative difference "
        f"{max(rel):.3g} (limit {TRAINER_LOSS_RTOL}); counts per step (fwd, dq, dkv, "
        f"plain) {res['counts']}; the worker's CUDA_VISIBLE_DEVICES {first['visible']!r}, "
        f"accelerator ids {first['accelerator_ids']}, {first['device_count']} card(s), "
        f"device {first['device']}")
    log(f"[trainer] checkpoint bitwise equal on the CPU: "
        f"{res['checkpoint_digest_equal']}; driver gauges {json.dumps(gauges)}; trace "
        f"window registered with the GCS: {res['trace_listed']}")
    if (any(s["counts"] != want for s in steps) or max(rel) > TRAINER_LOSS_RTOL
            or not losses[-1] < losses[0] or len(steps) != 1 + TRAIN_STEPS
            or first["visible"] is None or [first["visible"]] != first["accelerator_ids"]
            or first["device_count"] != 1 or not res["checkpoint_digest_equal"]
            or "ray_tpu_train_tokens_per_second" not in gauges or not res["trace_listed"]):
        raise AssertionError(f"the trainer phase: {res}")
    return res


# ------------------------------------------------------------ 18. data


def _split_tokens(block):
    """A map_batches stage: rows of T + 1 tokens into ``idx`` (the first T)
    and ``targets`` (the last T), as phase 7 builds its batch."""
    return {"idx": block["tokens"][:, :-1], "targets": block["tokens"][:, 1:]}


def data_dataset(rd, vocab: int):
    """The data phase's Dataset: phase 7's TRAIN_BATCH (the same draws of
    ``default_rng(0)``, each row followed by its first token, so the split
    gives phase 7's idx and np.roll'd targets) once per step of phase 7's
    run, one block each, then DATA_TAIL_BATCHES batches of further draws
    in DATA_TAIL_BLOCKS blocks, shuffled with seed 0; both mapped into idx
    / targets by tasks."""
    b, t = TRAIN_BATCH
    rng = np.random.default_rng(0)
    idx = rng.integers(0, vocab, TRAIN_BATCH)
    rows = np.concatenate([idx, idx[:, :1]], axis=1)
    head = rd.from_numpy(np.tile(rows, (1 + TRAIN_STEPS, 1)), column="tokens",
                         override_num_blocks=1 + TRAIN_STEPS)
    tail = rd.from_numpy(rng.integers(0, vocab, (DATA_TAIL_BATCHES * b, t + 1)),
                         column="tokens", override_num_blocks=DATA_TAIL_BLOCKS)
    return head.map_batches(_split_tokens).union(
        tail.map_batches(_split_tokens).random_shuffle(seed=0))


def _row_digests(batch):
    """sha256 of each row of a batch (its idx, then its targets, as int64
    bytes), in row order."""
    idx, targets = (np.ascontiguousarray(np.asarray(batch[k]), dtype=np.int64)
                    for k in ("idx", "targets"))
    return [hashlib.sha256(idx[i].tobytes() + targets[i].tobytes()).hexdigest()
            for i in range(len(idx))]


def _data_loop(config):
    """The loop of the data phase, run by the one ``use_gpu`` worker:
    GPT-2-124M as in phase 7, every batch from
    ``get_dataset_shard("train").iter_torch_batches(batch_size=16)`` on the
    worker's card. Each step is reported with the host ms its ``next()``
    waited, its ms, loss, counts and the batch's (device, dtype); a trace
    window covers DATA_TRACED_STEPS steps and the ``next()`` between them;
    then the digest of every row the worker got, each batch's H2D copy ms,
    the window's numbers, and the tokens/s the iterator delivers to the
    card when iterated alone. Like the trainer phase's loop it reaches no
    torch through its globals."""
    device, start = _worker_start()
    t0 = time.perf_counter()
    import torch as _torch

    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.train_step import TrainStep
    from ray_tpu_torch.train import _telemetry

    cfg = GPT2Config.gpt2_124m()
    ts = TrainStep(cfg, device=device)
    state = ts.init(_torch.Generator().manual_seed(0))
    shard = rtrain.get_dataset_shard("train")
    it = shard.iter_torch_batches(batch_size=TRAIN_BATCH[0])
    start["build_s"] = time.perf_counter() - t0
    rows = []
    for step in range(config["steps"]):
        if step == config["traced_step"] and not _telemetry.request_device_trace(
                DATA_TRACED_STEPS, config["trace_dir"]):
            raise AssertionError("no current recorder to open a trace window")
        t0 = time.perf_counter()
        batch = next(it)
        wait_ms = (time.perf_counter() - t0) * 1e3
        kinds = sorted({(v.device.type, str(v.dtype)) for v in batch.values()})
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)   # ends in a synchronise (telemetry)
        ms = (time.perf_counter() - t0) * 1e3
        rows += _row_digests({k: v.cpu().numpy() for k, v in batch.items()})
        rtrain.report({**start, "step": step, "n_layer": cfg.n_layer,
                       "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                       "step_ms": ms, "wait_ms": wait_ms, "kinds": kinds,
                       "counts": list(read_counts())})
    if next(it, None) is not None:
        raise AssertionError("the shard holds more batches than the steps")
    window = _telemetry.read_device_trace(ts.telemetry.device_trace.last_trace)
    del ts, state, batch
    # the iterator alone: the same shard again (its map stage reruns; the
    # shuffled blocks are already in the store), every batch landed
    t0 = time.perf_counter()
    tokens = batches = 0
    for b in shard.iter_torch_batches(batch_size=TRAIN_BATCH[0]):
        tokens += b["idx"].numel()
        batches += 1
    _torch.cuda.synchronize(device)
    alone_s = time.perf_counter() - t0
    rtrain.report({"step": "end", "digest": hashlib.sha256("".join(rows).encode()).hexdigest(),
                   "copy_ms": it.copy_ms,
                   "window": {k: window[k] for k in ("window_us", "busy_us", "busy_share",
                                                     "copy_us", "lead_us", "gap_us",
                                                     "tail_us")},
                   "alone_tokens": tokens, "alone_batches": batches,
                   "alone_s": alone_s})


def phase_data(card: str, train):
    """``TorchTrainer(loop, datasets={"train": ds}).fit()`` on the card (a
    new ``init(num_cpus=DATA_CPUS)``: the worker's bundle holds one CPU,
    the map and shuffle tasks lease the others): :func:`_data_loop` trains
    GPT-2-124M from :func:`data_dataset`. Checks: 24 / 12 / 12 launches and
    no plain call a step, every batch on cuda as int64, the first steps'
    losses within TRAINER_LOSS_RTOL of the train phase's (the same batch,
    seed and steps) and falling, the digest of the rows the worker got
    equal to that of ``ds.take_all()`` on the driver. Prints the host ms each ``next()`` waited, the H2D copy
    ms, the step ms beside the train phase's median, the window's busy
    share and the tokens/s the iterator alone delivers; none is checked."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    scratch = tempfile.mkdtemp(prefix="chip_smoke_data_")
    head_steps = 1 + TRAIN_STEPS
    steps = head_steps + DATA_TAIL_BATCHES
    rt.init(num_cpus=DATA_CPUS)
    try:
        t0 = time.time()
        ds = data_dataset(rd, GPT2Config.gpt2_124m().vocab_size)
        build_s = time.time() - t0
        fit_start = time.time()
        result = TorchTrainer(
            _data_loop,
            train_loop_config={"steps": steps, "traced_step": head_steps,
                               "trace_dir": str(Path(scratch) / "trace")},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=scratch, name="data"),
            datasets={"train": ds}).fit()
        fit_s = time.time() - fit_start
        rows = ds.take_all()
        driver_digest = hashlib.sha256("".join(
            d for r in rows for d in _row_digests({k: [v] for k, v in r.items()})
        ).encode()).hexdigest()
    finally:
        stop_runtime(rt)
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)

    history = result.metrics_history
    per_step = [h for h in history if isinstance(h.get("step"), int)]
    end = history[-1]
    first = per_step[0]
    want = [2 * first["n_layer"], first["n_layer"], first["n_layer"], 0]
    losses = [s["loss"] for s in per_step]
    ref = train["losses"][:head_steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:head_steps], ref)]
    traced = range(head_steps, head_steps + DATA_TRACED_STEPS)
    timed = [s["step_ms"] for s in per_step[1:] if s["step"] not in traced]
    wait_ms = [s["wait_ms"] for s in per_step]
    copy_ms = end["copy_ms"]
    tokens_per_step = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    res = {"fit_s": fit_s, "dataset_build_s": build_s, "rows": len(rows),
           "losses": losses, "train_phase_losses": ref,
           "loss_max_rel_diff": max(rel), "bitwise_equal_losses": losses[:head_steps] == ref,
           "step_ms": [s["step_ms"] for s in per_step],
           "median_step_ms": statistics.median(timed),
           "train_phase_median_step_ms": train["median_step_ms"],
           "wait_ms": wait_ms, "median_wait_ms": statistics.median(wait_ms[1:]),
           "copy_ms": copy_ms, "median_copy_ms": statistics.median(copy_ms),
           "window": end["window"],
           "alone_tokens_per_s": end["alone_tokens"] / end["alone_s"],
           "alone_batches": end["alone_batches"],
           "consumed_tokens_per_s": tokens_per_step / (statistics.median(timed) / 1e3),
           "tokens_per_step": tokens_per_step,
           "kinds": sorted({tuple(k) for s in per_step for k in s["kinds"]}),
           "counts": [s["counts"] for s in per_step],
           "launches": [sum(s["counts"][i] for s in per_step[1:]) for i in range(3)],
           "plain_calls": sum(s["counts"][3] for s in per_step),
           "digest_equal": end["digest"] == driver_digest,
           "startup": {"worker_import_torch_s": first["import_torch_s"],
                       "worker_cuda_context_s": first["cuda_context_s"],
                       "build_s": first["build_s"]}}
    w = end["window"]
    log(f"[data] TorchTrainer(datasets=...).fit() of GPT-2-124M (bf16, batch "
        f"{TRAIN_BATCH}) from a Dataset of {len(rows)} rows ({1 + TRAIN_STEPS} blocks of "
        f"the train phase's batch, then {DATA_TAIL_BATCHES} batches shuffled with seed 0): "
        f"{fit_s:.2f} s in all, {steps} steps on {card}")
    log(f"[data] next() waited {[round(x, 3) for x in wait_ms]} ms on the host "
        f"(median after the first {res['median_wait_ms']:.3f}); H2D copy per batch "
        f"{[round(x, 4) for x in copy_ms]} ms by CUDA events (median "
        f"{res['median_copy_ms']:.4f}); on {card}")
    log(f"[data] steps {[round(x, 2) for x in res['step_ms']]} ms (the first the "
        f"warm-up, {head_steps}-{head_steps + DATA_TRACED_STEPS - 1} traced), median "
        f"{res['median_step_ms']:.2f} ms beside the train phase's "
        f"{train['median_step_ms']:.2f}; trace window over {DATA_TRACED_STEPS} steps and "
        f"the next() between them: {w['window_us'] / 1e3:.2f} ms, device busy "
        f"{w['busy_us'] / 1e3:.2f} ms = {w['busy_share']:.3f} of it (copies and memsets "
        f"{w['copy_us'] / 1e3:.3f} ms); on {card}")
    log(f"[data] the iterator alone delivers {res['alone_tokens_per_s']:.0f} tokens/s "
        f"to the card ({end['alone_batches']} batches in {end['alone_s']:.3f} s) beside the "
        f"{res['consumed_tokens_per_s']:.0f} tokens/s training consumes ({tokens_per_step} "
        f"a step at the median step); on {card}")
    log(f"[data] losses {[round(x, 4) for x in losses]}; the first {head_steps} vs the "
        f"train phase's: largest relative difference {max(rel):.3g} (limit "
        f"{TRAINER_LOSS_RTOL}), bitwise {res['bitwise_equal_losses']}; batches "
        f"{res['kinds']}; counts per step (fwd, dq, dkv, plain) {res['counts']}; rows "
        f"digest equal to the driver's take_all(): {res['digest_equal']}")
    if (any(s["counts"] != want for s in per_step) or max(rel) > TRAINER_LOSS_RTOL
            or not losses[head_steps - 1] < losses[0] or len(per_step) != steps
            or res["kinds"] != [("cuda", "torch.int64")] or not res["digest_equal"]
            or len(rows) != steps * TRAIN_BATCH[0] or len(copy_ms) != steps
            or not all(np.isfinite(losses))):
        raise AssertionError(f"the data phase: {res}")
    return res


def _rl_probe_classes():
    """A ``TorchLearner`` that reports its device, its lease and its start,
    and a ``SingleAgentEnvRunner`` that reports which of torch, gymnasium
    and JAX its process holds; defined here and sent to the actors by
    value. The phase binds them where the algorithm binds the port's
    classes (in the driver only), so the actors' options stay the
    algorithm's own."""
    from ray_tpu_torch.rllib.core.learner import TorchLearner
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    class ProbeLearner(TorchLearner):
        def __init__(self, *args, **kwargs):
            import os

            import psutil

            entered = time.time()
            t0 = time.perf_counter()
            import torch as _torch  # the process's first import of it

            import_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if _torch.cuda.is_available():
                _torch.zeros(1, device="cuda").sum().item()
            context_s = time.perf_counter() - t0
            super().__init__(*args, **kwargs)
            self._start = {"process_start": psutil.Process().create_time(),
                           "init_entered": entered, "import_torch_s": import_s,
                           "cuda_context_s": context_s, "ready": time.time(),
                           "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

        def probe(self) -> dict:
            import ray_tpu_torch

            state = [t for s in self.opt.state.values() for t in s.values()
                     if hasattr(t, "device")]
            return {**self._start, "device": str(self.device),
                    "accelerator_ids": ray_tpu_torch.get_runtime_context()
                    .get_accelerator_ids()["GPU"],
                    "param_devices": sorted({str(p.device) for p in self.module.parameters()}),
                    "opt_state_devices": sorted({str(t.device) for t in state})}

    class ProbeRunner(SingleAgentEnvRunner):
        def modules(self) -> list:
            import sys as _sys

            return sorted({m.split(".")[0] for m in _sys.modules}
                          & {"torch", "gymnasium", "jax"})

    return ProbeLearner, ProbeRunner


def _rl_on_card(devices) -> bool:
    """Every tensor of ``devices`` (a sorted list of device names) on the
    card this process uses."""
    return devices == ["cuda:0"]


def _rl_learner_on_lease(probe) -> bool:
    """The probed learner actor runs on cuda, on the card its lease named in
    CUDA_VISIBLE_DEVICES, with its parameters and Adam state there."""
    return (probe["device"] == "cuda" and bool(probe["visible"])
            and [probe["visible"]] == probe["accelerator_ids"]
            and _rl_on_card(probe["param_devices"])
            and _rl_on_card(probe["opt_state_devices"]))


def _rl_tensors(learner):
    """(parameters, optimizer-state tensors) of every module and optimizer
    a learner holds."""
    mods = [getattr(learner, n) for n in ("module", "actor", "critic", "target")
            if hasattr(learner, n)]
    opts = [getattr(learner, n) for n in ("opt", "actor_opt", "critic_opt", "alpha_opt")
            if hasattr(learner, n)]
    params = [p for m in mods for p in m.parameters()]
    if hasattr(learner, "log_alpha"):
        params.append(learner.log_alpha)
    state = [t for o in opts for s in o.state.values() for t in s.values()
             if isinstance(t, torch.Tensor)]
    return params, state


def rl_learner_parity(card: str):
    """One update of each learner class on the card against the same update
    on the CPU, from the same weights (both drawn on the CPU from one seed)
    and batch: losses and aux within RL_REL_TOL relative (RL_ABS_FLOOR for
    a value that is zero up to rounding), parameters within RL_REL_TOL
    relative or, where Adam's first step turns a near-zero gradient of
    another summation order into ±lr, within 2·lr (under 1% of them); the
    card learner's parameters and optimizer state on cuda."""
    from ray_tpu_torch.rllib.algorithms import bc, dqn, sac
    from ray_tpu_torch.rllib.core import appo_learner, impala_learner, learner
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    runner = SingleAgentEnvRunner("CartPole-v1", 8, gamma=0.99, lambda_=0.95, seed=0)
    weights = learner.TorchLearner(4, 2, device="cpu").get_weights()
    batch = runner.sample(weights, 128)
    batch.pop("episode_returns")
    traj = runner.sample_trajectory(weights, 64)
    q_batch = dqn.DQNEnvRunner("CartPole-v1", 8, seed=1).sample(
        dqn.DQNLearner(4, 2, device="cpu").get_weights(), 32, 1.0)
    q_batch.pop("episode_returns")
    s_batch = sac.SACEnvRunner("Pendulum-v1", 8, seed=2).sample(None, 32, random=True)
    s_batch.pop("episode_returns")
    noise = np.random.default_rng(3).standard_normal((2, len(s_batch["obs"]), 1)
                                                     ).astype(np.float32)
    rtg = batch["returns"][:512]
    m_batches = [{"obs": batch["obs"][i:i + 256], "action": batch["actions"][i:i + 256]
                  .astype(np.int32), "return_to_go": (rtg[i:i + 256] - rtg.mean()) / rtg.std()}
                 for i in (0, 256)]
    cases = (
        ("TorchLearner", 3e-4, lambda d: learner.TorchLearner(4, 2, device=d),
         lambda lr: [lr.update_from_batch(batch, num_epochs=1,
                                          minibatch_size=len(batch["obs"]))]),
        ("ImpalaLearner", 5e-4, lambda d: impala_learner.ImpalaLearner(4, 2, device=d),
         lambda lr: [lr.update_from_trajectories(traj)]),
        ("AppoLearner", 5e-4, lambda d: appo_learner.AppoLearner(
            4, 2, use_kl_loss=True, target_update_freq=1, device=d),
         lambda lr: [lr.update_from_trajectories(traj), lr.update_from_trajectories(traj)]),
        ("DQNLearner", 1e-3, lambda d: dqn.DQNLearner(4, 2, device=d),
         lambda lr: [lr.update(q_batch)]),
        ("SACLearner", 3e-4, lambda d: sac.SACLearner(3, 1, [-2.0], [2.0], device=d),
         lambda lr: [lr.update_with_noise(s_batch, noise[0], noise[1])]),
        ("_MarwilLearner", 1e-3, lambda d: bc._MarwilLearner(4, 2, device=d),
         lambda lr: [lr.update(b) for b in m_batches]),
    )
    out = []
    for name, lr, make, update in cases:
        ref_l, got_l = make("cpu"), make(DEVICE)
        ref_aux = update(ref_l)
        t0 = time.perf_counter()
        got_aux = update(got_l)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        # each aux difference over its limit (RL_REL_TOL relative, RL_ABS_FLOOR)
        aux_share = max(abs(g[k] - r[k]) / (RL_REL_TOL * abs(r[k]) + RL_ABS_FLOOR)
                        for g, r in zip(got_aux, ref_aux) for k in r)
        aux_err = max((abs(g[k] - r[k]) / abs(r[k]) for g, r in zip(got_aux, ref_aux)
                       for k in r if abs(r[k]) > RL_ABS_FLOOR / RL_REL_TOL), default=0.0)
        got_p, got_s = _rl_tensors(got_l)
        ref_p, _ = _rl_tensors(ref_l)
        err = [(p.detach().cpu().double() - q.detach().double()).abs()
               for p, q in zip(got_p, ref_p)]
        outliers = sum(int((e > RL_REL_TOL * q.detach().double().abs() + RL_ABS_FLOOR).sum())
                       for e, q in zip(err, ref_p))
        size = sum(q.numel() for q in ref_p)
        devices = sorted({str(t.device) for t in got_p + got_s})
        res = {"learner": name, "updates": len(ref_aux), "aux_max_rel_err": aux_err,
               "aux_max_share_of_limit": aux_share,
               "param_max_abs_err": max(float(e.max()) for e in err), "lr": lr,
               "param_outliers": outliers, "params": size, "devices": devices,
               "opt_state_tensors": len(got_s), "card_update_s": card_s}
        log(f"[rllib] {name}: {len(ref_aux)} update(s) on the card against the CPU: "
            f"aux largest relative difference {aux_err:.3g} (limit {RL_REL_TOL}; every "
            f"difference at most {aux_share:.3g} of its limit with the {RL_ABS_FLOOR} floor), "
            f"parameters largest difference {res['param_max_abs_err']:.3g} (limit 2·lr "
            f"{2 * lr:g}), {outliers} of {size} beyond {RL_REL_TOL} relative; parameters "
            f"and {len(got_s)} optimizer-state tensors on {devices}; {card_s:.4f} s on {card}")
        if (aux_share > 1.0 or res["param_max_abs_err"] > 2 * lr + 1e-6
                or outliers > 0.01 * size or not _rl_on_card(devices) or not got_s):
            raise AssertionError(f"the rllib phase: {name}'s card update: {res}")
        out.append(res)
    return out


def _rl_timed(obj, name: str, sink: list, rows: bool = False) -> None:
    """Wrap ``obj.name`` (on the instance) to append each call's seconds,
    and with ``rows`` the row count of its first argument, to ``sink``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sink.append((time.perf_counter() - t0, len(args[0]["obs"])) if rows
                    else time.perf_counter() - t0)
        return out

    setattr(obj, name, timed)


def _rl_until(algo, iters: int):
    """``train()`` until the mean return reaches RL_THRESHOLD or ``iters``
    iterations have run: (best mean return, iterations run, last result,
    seconds of each iteration)."""
    best, secs, result = float("-inf"), [], {}
    for _ in range(iters):
        t0 = time.perf_counter()
        result = algo.train()
        secs.append(time.perf_counter() - t0)
        best = max(best, result["episode_return_mean"])
        if best >= RL_THRESHOLD:
            break
    return best, len(secs), result, secs


def _rl_losses_finite(result) -> bool:
    losses = [v for k, v in result.items() if k.startswith("learner/")]
    return bool(losses) and all(np.isfinite(losses))


def phase_rllib(card: str):
    """RLlib on the card (a new ``init(num_cpus=RL_CPUS)``; no gymnasium, no
    pyarrow on this machine: CartPole-v1 and Pendulum-v1 are the port's
    numpy copies). Checks: every learner class's update on the card against
    the CPU (:func:`rl_learner_parity`); PPO with ``tests/test_rllib.py``'s
    config to a mean return of RL_THRESHOLD within RL_PPO_ITERS iterations,
    its learner actor on cuda with the lease's CUDA_VISIBLE_DEVICES, no
    runner holding torch; APPO with ``tests/test_offline_rl.py``'s config to
    RL_THRESHOLD within RL_APPO_ITERS, its KL non-negative; RL_SHORT_ITERS
    iterations each of IMPALA (its learner in this process, on its card:
    APPO runs the engine's learner actor), DQN, SAC (Pendulum-v1, 256 x
    256) and multi-agent PPO with finite losses and the env steps their
    configs give; PPO at its default config (2 runners x 8 envs x 128 steps) saved
    and restored with the weights bitwise, in the driver and in the new
    learner. Prints iterations, the seconds of each part of a PPO
    iteration (sampling, the update, the weights' return), the update's env
    steps per second and the learner lease's start."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.rllib.core import learner as learner_mod
    from ray_tpu_torch.rllib.env import env_runner as runner_mod

    res = {"parity": rl_learner_parity(card)}
    scratch = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    rt.init(num_cpus=RL_CPUS)
    try:
        # PPO to the threshold, through the probes
        cfg = (rl.PPOConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=4, num_envs_per_env_runner=8,
                            rollout_fragment_length=64)
               .training(lr=1e-3, num_epochs=8, minibatch_size=256, entropy_coeff=0.005)
               .learners(num_gpus_per_learner=RL_GPUS).debugging(seed=0))
        real = learner_mod.TorchLearner, runner_mod.SingleAgentEnvRunner
        learner_mod.TorchLearner, runner_mod.SingleAgentEnvRunner = _rl_probe_classes()
        try:
            build_start = time.time()
            algo = cfg.build()
            build_s = time.time() - build_start
        finally:
            learner_mod.TorchLearner, runner_mod.SingleAgentEnvRunner = real
        try:
            sample_s, update_s, weights_s = [], [], []
            _rl_timed(algo.env_runner_group, "sample", sample_s)
            _rl_timed(algo.learner_group, "update_from_batch", update_s, rows=True)
            _rl_timed(algo.learner_group, "get_weights", weights_s)
            best, iters, last, secs = _rl_until(algo, RL_PPO_ITERS)
            probe = rt.get(algo.learner_group._actor.probe.remote(), timeout=60)
            modules = rt.get([r.modules.remote() for r in algo.env_runner_group.runners],
                             timeout=60)
        finally:
            algo.stop()
        steps_per_s = [rows / s for s, rows in update_s]
        ppo = {"best": best, "iterations": iters, "build_s": build_s,
               "iteration_s": secs, "sample_s": sample_s,
               "update_s": [s for s, _ in update_s], "weights_s": weights_s,
               "update_env_steps_per_s": steps_per_s,
               "env_steps": last["num_env_steps_sampled_lifetime"],
               "lease": {"learner_ready_s": probe["ready"] - build_start,
                         "worker_process_to_init_s": probe["init_entered"]
                         - probe["process_start"],
                         "learner_init_s": probe["ready"] - probe["init_entered"],
                         "import_torch_s": probe["import_torch_s"],
                         "cuda_context_s": probe["cuda_context_s"],
                         "visible": probe["visible"],
                         "accelerator_ids": probe["accelerator_ids"]},
               "learner_device": probe["device"], "param_devices": probe["param_devices"],
               "opt_state_devices": probe["opt_state_devices"], "runner_modules": modules}
        med = statistics.median
        log(f"[rllib] PPO on CartPole-v1 (4 runners x 8 envs x 64 steps, 8 epochs of 256, "
            f"the learner on a leased card): mean return {best:.1f} after {iters} "
            f"iterations (threshold {RL_THRESHOLD}, limit {RL_PPO_ITERS}); on {card}")
        log(f"[rllib] PPO iteration median {med(secs):.4f} s: sampling {med(sample_s):.4f} s, "
            f"the update {med(ppo['update_s']):.4f} s ({med(steps_per_s):.0f} env steps/s; "
            f"range {min(steps_per_s):.0f}-{max(steps_per_s):.0f}), the weights' return "
            f"{med(weights_s):.4f} s; first iteration {secs[0]:.4f} s; on {card}")
        log(f"[rllib] PPO build {build_s:.2f} s; the learner ready {ppo['lease']['learner_ready_s']:.2f} "
            f"s after build() began (its worker's start to __init__ "
            f"{ppo['lease']['worker_process_to_init_s']:.2f} s, __init__ "
            f"{ppo['lease']['learner_init_s']:.2f} s: torch's import "
            f"{probe['import_torch_s']:.2f} s, the CUDA context {probe['cuda_context_s']:.2f} "
            f"s, then the port's imports and the module); learner "
            f"device {probe['device']}, CUDA_VISIBLE_DEVICES {probe['visible']!r} (accelerator "
            f"ids {probe['accelerator_ids']}), parameters on {probe['param_devices']}, Adam "
            f"state on {probe['opt_state_devices']}; runners hold {modules}; on {card}")
        if best < RL_THRESHOLD or not _rl_learner_on_lease(probe) or any(modules):
            raise AssertionError(f"the rllib phase: PPO: {ppo}")
        res["ppo"] = ppo

        # APPO to the threshold
        t0 = time.time()
        algo = (rl.APPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=4, num_envs_per_env_runner=8,
                             rollout_fragment_length=32)
                .training(lr=3e-3, entropy_coeff=0.01, train_iter_env_steps=6144,
                          clip_param=0.3, target_update_freq=4)
                .learners(num_gpus_per_learner=RL_GPUS).debugging(seed=0).build())
        build_s = time.time() - t0
        try:
            best, iters, last, secs = _rl_until(algo, RL_APPO_ITERS)
        finally:
            algo.stop()
        res["appo"] = {"best": best, "iterations": iters, "build_s": build_s,
                       "iteration_s": secs, "kl": last["learner/kl"],
                       "updates": last["num_learner_updates"],
                       "learner_env_steps_per_s": last["learner/learner_env_steps_per_s"]}
        log(f"[rllib] APPO on CartPole-v1 (4 runners x 8 envs x 32 steps, 6144 env steps "
            f"an iteration): mean return {best:.1f} after {iters} iterations (threshold "
            f"{RL_THRESHOLD}, limit {RL_APPO_ITERS}), {last['num_learner_updates']} updates, "
            f"learner/kl {last['learner/kl']:.4g}; build {build_s:.2f} s, iteration median "
            f"{med(secs):.4f} s, the learner's env steps/s in its last iteration "
            f"{last['learner/learner_env_steps_per_s']:.0f}; on {card}")
        if best < RL_THRESHOLD or not last["learner/kl"] >= 0.0:
            raise AssertionError(f"the rllib phase: APPO: {res['appo']}")

        # three iterations each: (name, config, env steps after them: exact or
        # (low, high)); IMPALA's learner on this process's card (APPO ran the
        # engine's learner actor; a lease costs 15-25 s of imports)
        impala = rl.IMPALAConfig().environment("CartPole-v1")
        impala.remote_learner = False
        short = (
            ("impala", impala, RL_SHORT_ITERS * 4096),
            ("dqn", rl.DQNConfig().environment("CartPole-v1")
             .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                          rollout_fragment_length=32)
             .training(lr=1e-3, train_batch_size=256, updates_per_iteration=64,
                       target_update_freq=2, epsilon_decay_iters=25, learning_starts=500),
             (0.8 * RL_SHORT_ITERS * 512, RL_SHORT_ITERS * 512)),
            ("sac", rl.SACConfig().environment("Pendulum-v1")
             .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                          rollout_fragment_length=32)
             .training(learning_starts=256), RL_SHORT_ITERS * 256),
            ("multi_agent_ppo", rl.MultiAgentPPOConfig()
             .environment(lambda: rl.MultiAgentCartPole(num_agents=2))
             .multi_agent(policy_mapping_fn=lambda aid: aid),
             (RL_SHORT_ITERS * 2 * 256, RL_SHORT_ITERS * 2 * 2 * 256)),
        )
        for name, cfg, want in short:
            t0 = time.time()
            algo = cfg.learners(num_gpus_per_learner=RL_GPUS).debugging(seed=0).build()
            build_s = time.time() - t0
            try:
                secs, results = [], []
                for _ in range(RL_SHORT_ITERS):
                    t0 = time.perf_counter()
                    results.append(algo.train())
                    secs.append(time.perf_counter() - t0)
            finally:
                algo.stop()
            steps = results[-1]["num_env_steps_sampled_lifetime"]
            losses = {k: v for k, v in results[-1].items() if k.startswith("learner/")}
            res[name] = {"build_s": build_s, "iteration_s": secs, "env_steps": steps,
                         "losses": losses}
            log(f"[rllib] {name}: {RL_SHORT_ITERS} iterations of {[round(s, 4) for s in secs]} "
                f"s (build {build_s:.2f} s), {steps} env steps, last losses "
                f"{ {k: round(v, 5) for k, v in losses.items()} }; on {card}")
            in_range = (steps == want if isinstance(want, int)
                        else want[0] <= steps <= want[1])
            if not (_rl_losses_finite(results[-1]) and in_range):
                raise AssertionError(f"the rllib phase: {name}: {res[name]}")

        # the default config, saved and restored
        t0 = time.time()
        algo = (rl.PPOConfig().environment("CartPole-v1")
                .learners(num_gpus_per_learner=RL_GPUS).build())
        build_s = time.time() - t0
        try:
            secs = []
            for _ in range(RL_SHORT_ITERS):
                t0 = time.perf_counter()
                algo.train()
                secs.append(time.perf_counter() - t0)
            path = algo.save(str(Path(scratch) / "ppo"))
            w0 = algo.get_weights()
        finally:
            algo.stop()
        algo = rl.PPO.from_checkpoint(path)
        try:
            restored = [algo.get_weights(), algo.learner_group.get_weights()]
            resumed = algo.train()["training_iteration"]
        finally:
            algo.stop()
        bitwise = all(w[k][p].tobytes() == w0[k][p].tobytes()
                      for w in restored for k in w0 for p in ("kernel", "bias"))
        res["checkpoint"] = {"build_s": build_s, "iteration_s": secs, "bitwise": bitwise,
                             "resumed_iteration": resumed}
        log(f"[rllib] PPO at its default config (2 runners x 8 envs x 128 steps, 64 x 64, "
            f"4 epochs of 512): iterations {[round(s, 4) for s in secs]} s (build "
            f"{build_s:.2f} s); save / from_checkpoint: weights bitwise in the driver and "
            f"back from the new learner on the card: {bitwise}, resumed at iteration "
            f"{resumed}; on {card}")
        if not bitwise or resumed != RL_SHORT_ITERS + 1:
            raise AssertionError(f"the rllib phase: checkpoint: {res['checkpoint']}")
    finally:
        stop_runtime(rt)
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)
    return res


def flat_params(model) -> np.ndarray:
    """Every parameter of ``model``, in its parameter order, as one flat
    fp32 numpy array on the host."""
    return torch.cat([p.detach().reshape(-1).cpu() for p in model.parameters()]).numpy()


def load_flat(model, flat) -> None:
    """Fill ``model``'s parameters, in order, from one flat fp32 array (a
    read-only object-store view is fine: it is copied to the device once)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # a read-only view: only ever read
        src = torch.from_numpy(flat)
    src = src.to(next(model.parameters()).device)
    offset = 0
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(src[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
    if offset != src.numel():
        raise AssertionError(f"{src.numel()} weights for {offset} parameters")


def _flat_digest(a) -> str:
    return hashlib.sha256(memoryview(np.ascontiguousarray(a)).cast("B")).hexdigest()


def _node_reader(weights):
    """A task on one node: its node and the digest of the weights as that
    node's object store holds them."""
    import ray_tpu_torch

    return ray_tpu_torch.get_runtime_context().get_node_id(), _flat_digest(weights)


class MultinodeServer:
    """A GPU actor of the multinode phase: GPT-2 (``cfg``) in fp32 on its
    leased card, its weights loaded from the broadcast array (no seed);
    serves one prompt a call through LLMEngine and computes the gradient
    of one batch through TrainStep, all-reduced over the host plane."""

    def __init__(self, name: str, cfg, weights):
        import os

        import ray_tpu_torch
        from ray_tpu_torch.models.gpt2 import GPT2
        from ray_tpu_torch.serve.llm.adapters import GPT2Adapter

        t0 = time.perf_counter()
        model = GPT2(cfg, device=DEVICE)
        load_flat(model, weights)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        self.name, self.cfg = name, cfg
        self.adapter = GPT2Adapter(cfg, model)
        ctx = ray_tpu_torch.get_runtime_context()
        self.where = {"node": ctx.get_node_id(),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "accelerator_ids": ctx.get_accelerator_ids(),
                      "device_count": torch.cuda.device_count()}

    def ready(self):
        return dict(self.where, build_s=self.build_s)

    def serve(self, item):
        """``item`` is (request, prompt): the greedy tokens as Python ints,
        with this call's launches and plain calls."""
        from ray_tpu_torch.serve.llm import LLMEngine

        i, prompt = item
        engine = LLMEngine(self.adapter, name=f"multinode_{self.name}")
        reset_counts()
        outputs, wall = drive_engine(engine, [prompt], SERVE_MAX_TOKENS)
        counts = read_counts()
        return {"i": i, "tokens": [int(t) for t in outputs[0]], "wall_s": wall,
                "launches": counts[0], "plain_calls": counts[3], "actor": self.name}

    def grads(self, group: str, rank: int, idx, targets):
        """loss_and_grads on one batch, the gradients flattened into one
        tensor on the card, all-reduced over ``group`` in place, halved.
        Returns the loss, the counts, the times, the tensor's device and
        digest, and (rank 0) the halved gradient on the host."""
        from ray_tpu_torch.parallel.train_step import TrainStep
        from ray_tpu_torch.util import collective

        ts = TrainStep(self.cfg, device=DEVICE, telemetry=False)
        # np.array: the arguments arrive as read-only views
        batch = ts.shard_batch({"idx": np.array(idx), "targets": np.array(targets)})
        reset_counts()
        loss, grads = ts.loss_and_grads({"params": self.adapter.model}, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        del grads
        # the two host copies the all-reduce makes, timed alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = flat.cpu()
        d2h_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host.to(DEVICE)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        del host
        ptr = flat.data_ptr()
        t0 = time.perf_counter()
        out = collective.allreduce(flat, group)
        torch.cuda.synchronize()
        allreduce_s = time.perf_counter() - t0
        in_place = (out is flat and flat.data_ptr() == ptr
                    and flat.device.type == torch.device(DEVICE).type)
        flat.mul_(0.5)
        halved = flat.cpu().numpy()
        return {"loss": loss.item(), "counts": counts, "device": str(out.device),
                "in_place": in_place, "numel": flat.numel(), "d2h_s": d2h_s,
                "h2d_s": h2d_s, "allreduce_s": allreduce_s,
                "digest": _flat_digest(halved),
                "halved": halved if rank == 0 else None}


def _client_lines(proc, sink):
    for line in proc.stdout:
        sink.put(line)


def stop_cluster(rt, cluster, extra=()) -> None:
    """Stop the processes ``extra``, ``rt.shutdown()``, ``cluster.shutdown()``,
    then wait for every process they started (as ``stop_runtime``): any
    still alive after RUNTIME_STOP_S is killed."""
    import psutil

    for proc in extra:
        proc.terminate()
    procs = script_children()
    try:
        rt.shutdown()
    finally:
        cluster.shutdown()
    gone, alive = psutil.wait_procs(procs, timeout=RUNTIME_STOP_S)
    for proc in alive:
        proc.kill()
    psutil.wait_procs(alive, timeout=10)
    log(f"[multinode] shutdown: {len(gone)} of the phase's {len(procs)} "
        f"processes left within {RUNTIME_STOP_S} s, {len(alive)} killed")


def phase_multinode(card: str, serve, runtime):
    """Three nodes on one machine with the card on one: GPT-2-124M's
    weights broadcast to every node, served by two GPU actors through an
    ActorPool and the forward kernel, their half-batch gradients
    all-reduced as one CUDA tensor over util.collective against the full
    batch's, a client in a torch-free process, a node's death. Every
    process the phase started is stopped before it returns or raises."""
    import os
    import queue as queue_mod
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, init_params
    from ray_tpu_torch.parallel.train_step import TrainStep
    from ray_tpu_torch.util import collective, state
    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.broadcast import broadcast_object
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    phase_t0 = time.perf_counter()
    cfg = GPT2Config.gpt2_124m(dtype=torch.float32)
    width = (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size)
    if width != SERVE_WIDTH or not cfg.remat:
        raise AssertionError(f"not GPT-2-124M at full width: {cfg}")
    weights = flat_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    want_digest = _flat_digest(weights)
    mb = weights.nbytes / 1e6
    res = {"weights_mb": mb}

    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"resources": {"CPU": MULTINODE_CPUS, "GPU": 0}})
    extra = []
    try:
        card_node = cluster.add_node(resources={"CPU": MULTINODE_CPUS, "GPU": 1})
        cpu_node = cluster.add_node(resources={"CPU": MULTINODE_CPUS, "GPU": 0})
        cluster.wait_for_nodes()
        rt.init(address=cluster.address)
        res["cluster_start_s"] = time.perf_counter() - t0
        card_id, cpu_id = card_node.node_id.hex(), cpu_node.node_id.hex()
        gpus = rt.cluster_resources().get("GPU", 0)
        nodes = state.list_nodes()
        view = sorted((n["state"], n["resources_total"].get("GPU", 0),
                       n["node_id"] == card_id) for n in nodes)
        log(f"[multinode] cluster of {len(nodes)} nodes up in "
            f"{res['cluster_start_s']:.2f} s: GPU total {gpus}; (state, GPU, card "
            f"node) {view}")
        if gpus != 1 or view != [("ALIVE", 0, False)] * 2 + [("ALIVE", 1, True)]:
            raise AssertionError(f"the cluster: GPU {gpus}, nodes {view}")

        # ---- the weights on every node
        ref = rt.put(weights)
        t0 = time.perf_counter()
        stats = broadcast_object(ref)
        res["broadcast_s"] = time.perf_counter() - t0
        res["broadcast_rounds"] = stats["rounds"]
        res["broadcast_mb_s_per_transfer"] = mb * stats["rounds"] / res["broadcast_s"]
        holders = sorted(n.hex() for n in stats["nodes"])
        # num_cpus=0: a finished task's lease stays cached a moment for
        # reuse, and must not hold the card node's CPUs from the actors
        readers = [rt.remote(num_cpus=0, scheduling_strategy=NodeAffinitySchedulingStrategy(
            n.node_id.hex()))(_node_reader).remote(ref) for n in cluster.nodes]
        read = rt.get(readers, timeout=300)
        log(f"[multinode] broadcast of {mb:.1f} MB: {len(stats['transfers'])} transfers "
            f"in {stats['rounds']} rounds, {res['broadcast_s']:.3f} s, "
            f"{res['broadcast_mb_s_per_transfer']:.1f} MB/s a transfer (rounds in "
            f"series) on one machine; digests on the nodes equal the driver's: "
            f"{[d == want_digest for _, d in read]}")
        if (len(stats["transfers"]) != 2 or holders != sorted(n.node_id.hex() for n in cluster.nodes)
                or sorted(n for n, _ in read) != holders
                or any(d != want_digest for _, d in read)):
            raise AssertionError(f"the broadcast: {stats}, {read}")

        # ---- two GPU actors on the card node, serving through a pool
        names = ("multinode_server_0", "multinode_server_1")
        t0 = time.perf_counter()
        servers = [rt.remote(num_gpus=0.5)(MultinodeServer).options(name=name)
                   .remote(name, cfg, ref) for name in names]
        ready, lease_s = [], []
        for s in servers:
            ready.append(rt.get(s.ready.remote(), timeout=600))
            lease_s.append(time.perf_counter() - t0)
        res["lease_start_s"] = lease_s
        res["actor_build_s"] = [r["build_s"] for r in ready]
        actors = {a["name"]: a for a in state.list_actors() if a["name"] in names}
        log(f"[multinode] two num_gpus=0.5 actors ready {[round(s, 2) for s in lease_s]} s "
            f"after creation (model build and weights to the card "
            f"{[round(r['build_s'], 2) for r in ready]} s): {ready}; list_actors "
            f"nodes on the card node: {[a['node_id'] == card_id for a in actors.values()]}")
        # a fractional lease names no card: the worker keeps its node's view
        # (the raylet's CUDA_VISIBLE_DEVICES, this process's), one card here
        node_view = os.environ.get("CUDA_VISIBLE_DEVICES")
        if (any(r["node"] != card_id or r["visible"] != node_view or r["device_count"] != 1
                for r in ready)
                or sorted(actors) != list(names)
                or any(a["node_id"] != card_id or a["state"] != "ALIVE"
                       for a in actors.values())):
            raise AssertionError(f"the pool's actors: {ready}, {actors}")

        prompts = serve["prompts"]
        pool = ActorPool(servers)
        runs = []   # the actors' first calls pay their processes' first launches
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append((list(pool.map_unordered(lambda a, item: a.serve.remote(item),
                                                 list(enumerate(prompts)))),
                         time.perf_counter() - t0))
        (cold, cold_s), (served, pool_s) = runs
        outputs = {r["i"]: r["tokens"] for r in served}
        if {r["i"]: r["tokens"] for r in cold} != outputs:
            raise AssertionError(f"the pool's two runs differ: {cold}, {served}")
        by_actor = {n: [r for r in served if r["actor"] == n] for n in names}
        n_tokens = SERVE_MAX_TOKENS * len(prompts)
        res["pool_tokens_per_s"] = n_tokens / pool_s
        res["pool_tokens_per_s_first_run"] = n_tokens / cold_s
        res["pool_launches"] = sum(r["launches"] for r in served)
        res["pool_plain_calls"] = sum(r["plain_calls"] for r in served)
        differ = {i: next(c for c, (a, b) in enumerate(zip(toks, serve["outputs"][i]))
                          if a != b)
                  for i, toks in outputs.items() if toks != serve["outputs"][i]}
        worst = 0.0
        if differ:   # each differing stream must be near-greedy from there on
            gaps = greedy_gaps(serve["cpu_model"], prompts, {i: outputs[i] for i in differ})
            worst = max(max(g[differ[i]:]) for i, g in gaps.items())
        res.update(pool_streams_equal=len(outputs) - len(differ),
                   pool_worst_gap=worst)
        log(f"[multinode] ActorPool.map_unordered: {len(prompts)} requests x "
            f"{SERVE_MAX_TOKENS} tokens in {pool_s:.3f} s, {res['pool_tokens_per_s']:.1f} "
            f"tokens/s (its first run {res['pool_tokens_per_s_first_run']:.1f}; one "
            f"prompt a call, a new engine each; phase 6 in process {serve['tokens_per_s']:.1f}, phase 15's "
            f"actor {runtime['serve_tokens_per_s']:.1f}) on {card}; requests per actor "
            f"{ {n: [r['i'] for r in rs] for n, rs in by_actor.items()} }; launches per "
            f"actor { {n: sum(r['launches'] for r in rs) for n, rs in by_actor.items()} }, "
            f"plain calls {res['pool_plain_calls']}; streams equal to phase 6's "
            f"{res['pool_streams_equal']}/{len(prompts)}, worst gap after a difference "
            f"{worst:.3g} (limit {GREEDY_TOL})")
        if (sorted(outputs) != list(range(len(prompts))) or res["pool_plain_calls"]
                or any(sum(r["launches"] for r in rs) == 0 for rs in by_actor.values())
                or worst > GREEDY_TOL):
            raise AssertionError(f"the pool's serving: {served}")

        # ---- half a batch each, the gradients all-reduced on the host plane
        rng = np.random.default_rng(1)
        idx = rng.integers(0, cfg.vocab_size, PARITY_BATCH)
        targets = np.roll(idx, -1, axis=1)
        collective.create_collective_group(servers, 2, [0, 1], group_name="multinode_grads")
        halves = rt.get([s.grads.remote("multinode_grads", r, idx[r:r + 1], targets[r:r + 1])
                         for r, s in enumerate(servers)], timeout=600)
        ts = TrainStep(cfg, device=DEVICE, telemetry=False)
        model = GPT2(cfg, device=DEVICE)
        load_flat(model, weights)
        names_sizes = [(n, p.numel()) for n, p in model.named_parameters()]
        loss_full, grads_full = ts.loss_and_grads(
            {"params": model}, ts.shard_batch({"idx": idx, "targets": targets}))
        halved = torch.from_numpy(halves[0]["halved"])
        offset, grad_rel = 0, 0.0
        for name, n in names_sizes:
            want = grads_full[name].detach().reshape(-1).cpu()
            if want.norm() > 0:
                got = halved[offset:offset + n]
                grad_rel = max(grad_rel, ((got - want).norm() / want.norm()).item())
            offset += n
        loss_half = (halves[0]["loss"] + halves[1]["loss"]) / 2
        loss_rel = abs(loss_half - loss_full.item()) / abs(loss_full.item())
        del model, grads_full, ts
        torch.cuda.empty_cache()
        want_counts = (2 * cfg.n_layer, cfg.n_layer, cfg.n_layer, 0)
        nbytes = halves[0]["numel"] * 4
        res.update(grads_launches=[sum(h["counts"][k] for h in halves) for k in range(3)],
                   grads_plain_calls=sum(h["counts"][3] for h in halves),
                   grads_loss_rel_err=loss_rel, grads_rel_err=grad_rel,
                   allreduce_s=[h["allreduce_s"] for h in halves],
                   allreduce_gb_s=[nbytes / h["allreduce_s"] / 1e9 for h in halves],
                   allreduce_d2h_s=[h["d2h_s"] for h in halves],
                   allreduce_h2d_s=[h["h2d_s"] for h in halves])
        log(f"[multinode] gradients: rows {PARITY_BATCH[0]} of {PARITY_BATCH} on two "
            f"actors, counts (fwd, dq, dkv, plain) {[h['counts'] for h in halves]} "
            f"(expected {want_counts} each); one {nbytes / 1e6:.1f} MB fp32 tensor each "
            f"on {[h['device'] for h in halves]}, all-reduced in place "
            f"{[h['in_place'] for h in halves]} in "
            f"{[round(s, 3) for s in res['allreduce_s']]} s "
            f"({[round(g, 3) for g in res['allreduce_gb_s']]} GB/s of payload over the "
            f"host ring of 2; its host copies alone: to the host "
            f"{[round(s, 3) for s in res['allreduce_d2h_s']]} s, back "
            f"{[round(s, 3) for s in res['allreduce_h2d_s']]} s) on {card}; halved "
            f"against the full batch's loss_and_grads on the card: loss rel "
            f"{loss_rel:.3g}, largest gradient rel (norm) {grad_rel:.3g} (limit "
            f"{RANKS_REL_TOL}); ranks' digests equal "
            f"{halves[0]['digest'] == halves[1]['digest']}")
        if (any(tuple(h["counts"]) != want_counts or not h["in_place"]
                or not h["device"].startswith(torch.device(DEVICE).type) for h in halves)
                or halves[0]["digest"] != halves[1]["digest"]
                or offset != halved.numel() or max(loss_rel, grad_rel) > RANKS_REL_TOL):
            raise AssertionError(f"the all-reduced gradients: loss {loss_rel}, grads "
                                 f"{grad_rel}, {[dict(h, halved=None) for h in halves]}")

        # ---- a client in a process without torch
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        server = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.util.client.server",
             "--address", cluster.address, "--port", "0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        extra.append(server)
        lines = queue_mod.Queue()
        threading.Thread(target=_client_lines, args=(server, lines), daemon=True).start()
        port, seen = None, []
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            try:
                line = lines.get(timeout=1)
            except queue_mod.Empty:
                if server.poll() is not None:
                    break
                continue
            seen.append(line)
            if "client server listening on" in line:
                port = int(line.strip().rsplit(" ", 1)[1])
        if port is None:
            raise AssertionError(f"the client server did not start: {''.join(seen)}")
        code = (
            "import json, sys, time\n"
            "from ray_tpu_torch.util import client\n"
            "t0 = time.perf_counter()\n"
            "ctx = client.connect(sys.argv[1])\n"
            "h = ctx.get_actor(sys.argv[2])\n"
            "got = ctx.get([h.serve.remote(item) for item in json.loads(sys.argv[3])])\n"
            "rt_s = time.perf_counter() - t0\n"
            "ctx.disconnect()\n"
            "print(json.dumps({'tokens': [g['tokens'] for g in got], 'round_trip_s': rt_s,\n"
            "    'ints': all(type(t) is int for g in got for t in g['tokens']),\n"
            "    'torch': sorted(m for m in sys.modules if m.split('.')[0] == 'torch')}))\n")
        items = [[i, prompts[i]] for i in (0, 1)]
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, "-c", code, f"127.0.0.1:{port}", names[1],
                               json.dumps(items)],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        client_s = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"the client failed: {done.stdout}{done.stderr}")
        got = json.loads(done.stdout.strip().splitlines()[-1])
        res.update(client_round_trip_s=got["round_trip_s"], client_process_s=client_s)
        log(f"[multinode] client (a process that imports only ray_tpu_torch.util.client): "
            f"connect, get_actor and two requests x {SERVE_MAX_TOKENS} tokens in "
            f"{got['round_trip_s']:.3f} s ({client_s:.2f} s with its interpreter); "
            f"token ids ints: {got['ints']}, equal to the pool's: "
            f"{got['tokens'] == [outputs[0], outputs[1]]}; torch modules in the client: "
            f"{got['torch']}")
        if got["tokens"] != [outputs[0], outputs[1]] or got["torch"] or not got["ints"]:
            raise AssertionError(f"the client: {got}")

        # ---- a node's death
        t0 = time.perf_counter()
        cluster.remove_node(cpu_node)
        states = {}
        while time.perf_counter() - t0 < MULTINODE_DEATH_S:
            states = {n["node_id"]: n["state"] for n in state.list_nodes()}
            if states.get(cpu_id) == "DEAD":
                break
            time.sleep(0.2)
        res["node_dead_s"] = time.perf_counter() - t0
        log(f"[multinode] remove_node of the CPU-only node: list_nodes shows it "
            f"{states.get(cpu_id)} after {res['node_dead_s']:.2f} s (limit "
            f"{MULTINODE_DEATH_S} s); the others {sorted(s for n, s in states.items() if n != cpu_id)}")
        if states.get(cpu_id) != "DEAD":
            raise AssertionError(f"the removed node: {states}")
    finally:
        stop_cluster(rt, cluster, extra)
    res["total_s"] = time.perf_counter() - phase_t0
    log(f"[multinode] phase {res['total_s']:.1f} s on {card}")
    return res


def flax_tree(model) -> dict:
    """``model``'s parameters as the JAX package's flax tree (nested dicts
    of fp32 numpy arrays, dense kernels as (in, out)): what
    ``load_flax_params`` reads."""
    from ray_tpu_torch.models._flax import flax_path

    tree = {}
    for name, p in model.named_parameters():
        path = flax_path(model, name).split("/")
        arr = p.detach().cpu().numpy()
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if path[-1] == "kernel" else arr)
    return tree


def sync() -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


class DagStage:
    """A stage of phase 21 on a num_gpus=0.5 lease of the card: half of
    GPT-2-124M (``cfg``, bf16 compute), loaded from the flax tree through
    ``load_flax_params``. Stage "a" keeps wte, wpe and the first half of the
    blocks; stage "b" the second half, ln_f and the tied head (wte)."""

    def __init__(self, part: str, cfg, tree):
        import ray_tpu_torch
        from ray_tpu_torch.models.gpt2 import GPT2, load_flax_params

        t0 = time.perf_counter()
        model = GPT2(cfg, device=DEVICE)
        load_flax_params(model, tree)
        half = cfg.n_layer // 2
        blocks = list(model.h)
        model.h = torch.nn.ModuleList(blocks[:half] if part == "a" else blocks[half:])
        if part == "a":
            model.ln_f = None
        else:
            model.wpe = None
        sync()
        self.build_s = time.perf_counter() - t0
        self.part, self.model, self.cfg, self.last = part, model, cfg, None
        self.where = {"part": part, "node": ray_tpu_torch.get_runtime_context().get_node_id(),
                      "device": str(next(model.parameters()).device),
                      "device_count": torch.cuda.device_count(),
                      "blocks": len(model.h),
                      "params": sum(p.numel() for p in model.parameters())}

    def ready(self):
        return dict(self.where, build_s=self.build_s)

    def head(self, idx):
        """Token ids (B, T) to the hidden state after the first half (bf16,
        on the card; the channel copies it to the host)."""
        idx = np.asarray(idx)
        if idx.ndim != 2 or idx.shape[1] > self.cfg.block_size:
            raise ValueError(f"token ids of shape {idx.shape}: a stage takes (B, T) "
                             f"with T <= {self.cfg.block_size}")
        with torch.inference_mode():
            idx = torch.from_numpy(idx.astype(np.int64)).to(DEVICE)
            pos = torch.arange(idx.shape[1], device=DEVICE)
            x = self.model.wte(idx) + self.model.wpe(pos)[None]
            for block in self.model.h:
                x = block(x)
        self.last = x
        return x

    def tail(self, x):
        """The hidden state (a CPU tensor off the channel) through the second
        half, ln_f and the head: the last position's logits in fp32 and every
        position's greedy token."""
        with torch.inference_mode():
            x = x.to(DEVICE)
            for block in self.model.h:
                x = block(x)
            logits = self.model.head(x)
            return {"last": logits[:, -1].float(), "greedy": logits.argmax(-1)}

    def copies(self, reps: int = 5):
        """The copies a channel hop makes of the last hidden state, timed
        apart: to the host and back to the card (medians, ms)."""
        h, d2h, h2d = self.last, [], []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            host = h.cpu()
            d2h.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            host.to(DEVICE)
            sync()
            h2d.append((time.perf_counter() - t0) * 1e3)
        return {"bytes": h.numel() * h.element_size(), "dtype": dtype_name(h.dtype),
                "d2h_ms": statistics.median(d2h), "h2d_ms": statistics.median(h2d)}


def _stage_reset(stage) -> bool:
    reset_counts()
    return True


def _stage_counts(stage):
    return list(read_counts())


def phase_dag(card: str, rt):
    """Phase 21: GPT-2-124M split over two num_gpus=0.5 actors on the card,
    ``b.tail.bind(a.head.bind(inp))`` compiled; its logits against the
    one-process forward, the forward kernel's launches in each stage, a
    raising input, compiled against eager ms, the hidden state's copies,
    teardown; then a dp learner of more cards than the machine has must
    raise. The caller's runtime (``rt``) is up; the phase kills its actors."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, init_params, load_flax_params
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    phase_t0 = time.perf_counter()
    cfg = GPT2Config.gpt2_124m(dtype=torch.bfloat16)
    width = (cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.vocab_size, cfg.block_size)
    if width != SERVE_WIDTH:
        raise AssertionError(f"not GPT-2-124M at full width: {cfg}")
    tree = flax_tree(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, cfg.vocab_size, DAG_BATCH) for _ in range(DAG_STEPS)]
    ref_model = load_flax_params(GPT2(cfg, device=DEVICE), tree)
    with torch.inference_mode():
        ref = []
        for bt in batches:
            logits = ref_model(torch.from_numpy(bt).to(DEVICE))
            ref.append({"last": logits[:, -1].float().cpu(), "greedy": logits.argmax(-1).cpu()})
    del ref_model, logits
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()
    res = {}

    t0 = time.perf_counter()
    stage = rt.remote(num_gpus=0.5)(DagStage)
    a, b = stage.remote("a", cfg, tree), stage.remote("b", cfg, tree)
    ready = rt.get([a.ready.remote(), b.ready.remote()], timeout=600)
    res["actors_ready_s"] = time.perf_counter() - t0
    log(f"[dag] two num_gpus=0.5 stage actors ready in {res['actors_ready_s']:.2f} s: "
        f"{ready}")
    on = "cuda:0" if torch.device(DEVICE).type == "cuda" else "cpu"
    if (any(r["device"] != on or r["blocks"] != cfg.n_layer // 2 for r in ready)
            or ready[0]["node"] != ready[1]["node"]):
        raise AssertionError(f"the stages: {ready}")

    with InputNode() as inp:
        out = b.tail.bind(a.head.bind(inp))
    t0 = time.perf_counter()
    dag = out.experimental_compile(buffer_size_bytes=DAG_BUFFER)
    res["compile_s"] = time.perf_counter() - t0
    try:
        dag.execute(batches[0]).get(timeout=600)   # the stages' first launches
        rt.get([h.__ray_call__.remote(_stage_reset) for h in (a, b)], timeout=60)
        got, ms = [], []
        for bt in batches:   # the main path
            t0 = time.perf_counter()
            got.append(dag.execute(bt).get(timeout=300))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = rt.get([h.__ray_call__.remote(_stage_counts) for h in (a, b)], timeout=60)
        t0 = time.perf_counter()
        pending = [dag.execute(bt) for bt in batches[:DAG_IN_FLIGHT]]
        piped = [r.get(timeout=300) for r in pending]
        res["in_flight_ms_per_execute"] = (time.perf_counter() - t0) * 1e3 / DAG_IN_FLIGHT
        try:
            dag.execute(np.zeros((1, cfg.block_size + 1), np.int64)).get(timeout=120)
            raised = None
        except ValueError as e:
            raised = str(e)
        again = dag.execute(batches[0]).get(timeout=300)
        copies = rt.get(a.copies.remote(), timeout=120)
    finally:
        t0 = time.perf_counter()
        dag.teardown()
        res["teardown_s"] = time.perf_counter() - t0
    eager_ms, eager = [], []
    rt.get(b.tail.remote(a.head.remote(batches[0])), timeout=300)
    for bt in batches:
        t0 = time.perf_counter()
        eager.append(rt.get(b.tail.remote(a.head.remote(bt)), timeout=300))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    for h in (a, b):
        rt.kill(h)

    err = max(float((g["last"] - r["last"]).abs().max() / r["last"].abs().max())
              for g, r in zip(got, ref))
    bitwise = all(_bitwise_equal(g["last"], r["last"]) and torch.equal(g["greedy"], r["greedy"])
                  for g, r in zip(got, ref))
    greedy_share = statistics.mean(float((g["greedy"] == r["greedy"]).float().mean())
                                   for g, r in zip(got, ref))
    same = all(torch.equal(x["last"], y["last"]) for x, y in zip(piped + eager + [again],
                                                                   got[:DAG_IN_FLIGHT] + got + got[:1]))
    n = DAG_STEPS
    want = [cfg.n_layer // 2 * n, 0, 0, 0]   # 6 a stage per execute at 12 layers
    res.update(
        stage_counts={"a": counts[0], "b": counts[1]}, launches_a=counts[0][0],
        launches_b=counts[1][0], plain_calls_a=counts[0][3], plain_calls_b=counts[1][3],
        compiled_ms=ms, median_compiled_ms=statistics.median(ms), eager_ms=eager_ms,
        median_eager_ms=statistics.median(eager_ms), logits_rel_err=err, bitwise=bitwise,
        greedy_equal_share=greedy_share, copies=copies, raised=raised,
        outputs_agree=same, stages=ready)
    log(f"[dag] compiled ({DAG_BUFFER >> 20} MiB channels, compile {res['compile_s']:.2f} s): "
        f"{n} executes of {DAG_BATCH} tokens, median {res['median_compiled_ms']:.2f} ms each "
        f"awaited, {res['in_flight_ms_per_execute']:.2f} ms each with {DAG_IN_FLIGHT} in "
        f"flight; eager .remote chain median {res['median_eager_ms']:.2f} ms, on {card}; "
        f"launches (fwd, dq, dkv, plain) a {counts[0]}, b {counts[1]} (expected {want} "
        f"each); last-position logits against the one-process forward: largest "
        f"difference {err:.3g} of the max logit (limit {LOGIT_TOL}), bitwise {bitwise}, "
        f"greedy tokens equal {greedy_share:.4f}; pipelined, eager and repeated outputs "
        f"equal {same}; a (1, {cfg.block_size + 1}) input raised at get(): {raised!r}; "
        f"the hidden state's copies ({copies['bytes']} B {copies['dtype']}) to the host "
        f"{copies['d2h_ms']:.3f} ms, back {copies['h2d_ms']:.3f} ms; teardown "
        f"{res['teardown_s']:.3f} s")
    if (counts[0] != want or counts[1] != want or err > LOGIT_TOL or not same
            or raised is None or "T <=" not in raised):
        raise AssertionError(f"the dag phase: {res}")

    # a dp learner of more cards than the machine has raises before a step
    cards = int(rt.cluster_resources().get("GPU", 0))
    try:
        LearnerGroup(4, 2, config={"mesh_devices": cards + 1})
        dp_error = None
    except RuntimeError as e:
        dp_error = str(e)
    res["dp_over_cards_error"] = dp_error
    log(f"[dag] LearnerGroup(mesh_devices={cards + 1}) on {cards} card(s): {dp_error!r}")
    if dp_error is None or f"cluster has {float(cards)} GPUs" not in dp_error:
        raise AssertionError(f"mesh_devices={cards + 1} on {cards} cards: {dp_error!r}")
    res["total_s"] = time.perf_counter() - phase_t0
    log(f"[dag] phase {res['total_s']:.1f} s on {card}")
    return res


def _wf_forward(cfg, seed: int, runs_path: str):
    """Workflow step 1 (num_gpus=1): GPT-2 (``cfg``) from seed 0 on the
    lease's card, the greedy tokens of a seeded DAG_BATCH as numpy, with this
    call's launch counts; each run appends to ``runs_path``."""
    from ray_tpu_torch.models.gpt2 import init_params

    with open(runs_path, "a") as f:
        f.write("1")
    model = init_params(cfg, torch.Generator().manual_seed(0), device=DEVICE)
    idx = np.random.default_rng(seed).integers(0, cfg.vocab_size, DAG_BATCH)
    reset_counts()
    with torch.inference_mode():
        tokens = model(torch.from_numpy(idx).to(DEVICE)).argmax(-1).cpu().numpy()
    sync()
    return {"tokens": tokens, "counts": list(read_counts())}


def _wf_finish(step1, flag_path: str):
    """Workflow step 2 (num_gpus=1): raises while ``flag_path`` exists; then
    returns step 1's tokens beside a CUDA tensor of them on its card (what
    storage keeps of a CUDA tensor)."""
    import os

    if os.path.exists(flag_path):
        raise RuntimeError("injected failure")
    on_card = torch.from_numpy(np.array(step1["tokens"])).to(DEVICE)
    return {"tokens": step1["tokens"], "counts": step1["counts"], "on_card": on_card,
            "device": str(on_card.device)}


def phase_workflow(card: str, rt):
    """Phase 22: a durable workflow of two num_gpus=1 steps (GPT-2-124M's
    forward, then a step that fails once), resumed; step 1 does not run
    again, the output equals a fresh run's, and the CUDA tensor step 2
    returned comes back from storage as a CPU tensor."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch import workflow
    from ray_tpu_torch.models.gpt2 import GPT2Config

    phase_t0 = time.perf_counter()
    cfg = GPT2Config.gpt2_124m(dtype=torch.bfloat16)
    storage = tempfile.mkdtemp(prefix="rtpu_torch_workflow_")
    try:
        workflow.init(storage=storage)
        forward = rt.remote(num_gpus=1)(_wf_forward)
        finish = rt.remote(num_gpus=1)(_wf_finish)
        runs, flag = os.path.join(storage, "runs"), os.path.join(storage, "flag")
        with open(flag, "w"):
            pass
        res = {}
        t0 = time.perf_counter()
        try:
            workflow.run(finish.bind(forward.bind(cfg, 22, runs), flag), workflow_id="phase22")
            first = None
        except Exception as e:  # noqa: BLE001 — the injected failure
            first = type(e).__name__
        res["first_run_s"] = time.perf_counter() - t0
        status_failed = workflow.get_status("phase22")
        steps_failed = sorted(os.listdir(os.path.join(storage, "phase22", "steps")))
        os.remove(flag)
        t0 = time.perf_counter()
        out = workflow.resume("phase22")
        res["resume_s"] = time.perf_counter() - t0
        with open(runs) as f:
            step1_runs = f.read()
        stored = workflow.get_output("phase22")
        t0 = time.perf_counter()
        fresh = workflow.run(finish.bind(forward.bind(cfg, 22, runs + "_fresh"), flag),
                             workflow_id="phase22_fresh")
        res["fresh_run_s"] = time.perf_counter() - t0
        steps = sorted(os.listdir(os.path.join(storage, "phase22", "steps")))
        with open(os.path.join(storage, "phase22", "meta.json")) as f:
            meta = sorted(json.load(f))
        status = workflow.get_status("phase22")
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    want = [cfg.n_layer, 0, 0, 0]
    on_card = out["on_card"]
    res.update(
        first_error=first, status_after_failure=status_failed, steps_after_failure=steps_failed,
        status=status, steps=steps, meta_keys=meta, step1_runs=len(step1_runs),
        step1_counts=out["counts"], launches=out["counts"][0], plain_calls=out["counts"][3],
        step2_device=out["device"],
        resumed_tensor={"type": type(on_card).__name__, "device": str(on_card.device),
                        "dtype": str(on_card.dtype)},
        equals_fresh=bool(np.array_equal(out["tokens"], fresh["tokens"])))
    log(f"[workflow] two num_gpus=1 steps: the first run {first} after "
        f"{res['first_run_s']:.2f} s (status {status_failed}, steps stored "
        f"{steps_failed}); resume {res['resume_s']:.2f} s, status {status}, steps "
        f"{steps}, meta keys {meta}; step 1 ran {len(step1_runs)} time(s), its "
        f"launches (fwd, dq, dkv, plain) {out['counts']} (expected {want}); step 2 on "
        f"{out['device']}; the CUDA tensor it returned came back from resume as a "
        f"{res['resumed_tensor']} (from storage: {type(stored['on_card']).__name__} on "
        f"{stored['on_card'].device}); output equal to a fresh run's "
        f"{res['equals_fresh']} (fresh run {res['fresh_run_s']:.2f} s) on {card}")
    if (first is None or status_failed != workflow.FAILED or status != workflow.SUCCESSFUL
            or steps_failed != ["r.0__wf_forward.pkl"] or len(step1_runs) != 1
            or out["counts"] != want or not res["equals_fresh"]
            or not out["device"].startswith(torch.device(DEVICE).type)
            or on_card.device.type != "cpu" or stored["on_card"].device.type != "cpu"
            or not np.array_equal(on_card.numpy(), out["tokens"])):
        raise AssertionError(f"the workflow phase: {res}")
    res["total_s"] = time.perf_counter() - phase_t0
    log(f"[workflow] phase {res['total_s']:.1f} s on {card}")
    return res


def phase_graphs(card: str):
    """Phases 21 and 22 on one runtime (``init(num_cpus=4)``, the card
    detected); every process it started is stopped before it returns."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        return phase_dag(card, rt), phase_workflow(card, rt)
    finally:
        stop_runtime(rt)


# ------------------------------------------------------------ the operator plane

OPERATOR_ENTRY = """\
import json, sys, time
sys.path.insert(0, sys.argv[1])
import ray_tpu_torch as rt

cfg = json.loads(sys.argv[2])
rt.init(address="auto")


@rt.remote(num_gpus=1)
class OperatorServer:
    def serve(self):
        import chip_smoke

        return chip_smoke.operator_serve()


print("DEMAND_AT", time.time(), flush=True)
server = OperatorServer.remote()
out = rt.get(server.serve.remote(), timeout=cfg["deadline_s"])
rt.kill(server)
print("IDLE_AT", time.time(), flush=True)
print("OPERATOR_RESULT " + json.dumps(out), flush=True)
print("TORCH_IN_DRIVER", "torch" in sys.modules, flush=True)
rt.shutdown()
"""


def operator_serve():
    """The job's actor (on the node the autoscaler launched): GPT-2-124M at
    full width built as phase 6 builds it, phase 6's prompts through
    ``LLMEngine``, the forward kernel's launches and plain calls read right
    after, then every greedy token teacher-forced on the card's plain
    (einsum) forward of the same weights."""
    import dataclasses

    from ray_tpu_torch.models.gpt2 import init_params
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    t0 = time.perf_counter()
    adapter = build_adapter("gpt2", seed=0, device=DEVICE)
    build_s = time.perf_counter() - t0
    engine = LLMEngine(adapter, name="operator")
    prompts = serve_prompts(adapter.cfg.vocab_size)
    reset_counts()
    outputs, wall = drive_engine(engine, prompts, SERVE_MAX_TOKENS)
    launches, _, _, plain_calls = read_counts()
    plain_cfg = dataclasses.replace(adapter.cfg, use_flash_attention=False)
    plain = init_params(plain_cfg, torch.Generator().manual_seed(0),
                        device=DEVICE).eval()
    same = all(torch.equal(a, b) for a, b in zip(plain.state_dict().values(),
                                                 adapter.model.state_dict().values()))
    gaps = greedy_gaps(plain, prompts, outputs)
    cfg_w = adapter.cfg
    return {"width": [cfg_w.n_layer, cfg_w.n_head, cfg_w.n_embd, cfg_w.vocab_size,
                      cfg_w.block_size],
            "launches": launches, "plain_calls": plain_calls,
            "tokens_per_s": SERVE_MAX_TOKENS * len(prompts) / wall,
            "build_s": build_s, "weights_equal": same,
            "worst_gap": max(max(g) for g in gaps.values()),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name(0),
            "torch_in_worker": "torch" in sys.modules}


def _cli(args, env, timeout=300):
    """``python -m ray_tpu_torch.scripts <args>`` as an operator runs it."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts", *args],
                         capture_output=True, text=True, env=env, timeout=timeout,
                         cwd=str(ROOT))
    if out.returncode != 0:
        raise AssertionError(f"ray-tpu-torch {' '.join(args)} exited "
                             f"{out.returncode}:\n{out.stdout}\n{out.stderr}")
    return out.stdout


def _http_json(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _plasma_segments(node_ids):
    """The plasma segments of these nodes still in /dev/shm (a raylet names
    its segment after its node id); another cluster's are not looked at."""
    names = (f"rtpu_torch_plasma_{node_id[:12]}" for node_id in node_ids)
    return sorted(name for name in names if (Path("/dev/shm") / name).exists())


def _job_lines(logs, key):
    return [line.split(" ", 1)[1] for line in logs.splitlines()
            if line.startswith(key + " ")]


def phase_operator(card: str, serve):
    """Phase 23: the operator plane on the card machine, through the CLI. A
    head started by ``ray-tpu-torch start`` without the card, its status and
    HTTP routes; an autoscaler over a FakeMultiNodeProvider whose one node
    type holds the card; a job submitted over HTTP whose actor makes the
    autoscaler launch that node and serves GPT-2-124M there through the
    forward kernel; the node removed once idle; a second job stopped with
    ``job stop``; ``perf check`` writing a ledger that ``perf history`` and
    ``/api/perf`` read back; ``stop`` leaving none of the phase's processes
    and none of its nodes' plasma segments."""
    import shutil
    import tempfile
    import threading

    import psutil

    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import (Autoscaler, FakeMultiNodeProvider,
                                          NodeTypeConfig)
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    tmp = Path(tempfile.mkdtemp(prefix="operator_"))
    history = tmp / "perf_history.jsonl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["RTPU_TORCH_STATE_FILE"] = str(tmp / "cli_cluster.json")   # this phase's cluster
    env["RTPU_TORCH_perf_history_path"] = str(history)             # the head's /api/perf
    node_ids = set()   # the phase's own nodes: the head and the launched one
    res = {}
    provider = scaler = url = None
    stopped = False
    try:
        # ---- 1. the head, as an operator starts it
        t0 = time.perf_counter()
        out = _cli(["start", "--head", "--resources", OPERATOR_HEAD_RESOURCES,
                    "--dashboard-port", "0"], env)
        gcs = out.split("GCS at ", 1)[1].split()[0]
        url = out.split("dashboard: ", 1)[1].split()[0]
        cluster = _http_json(f"{url}/api/cluster")
        res["head_ready_s"] = time.perf_counter() - t0
        node_ids |= {n["node_id"] for n in _http_json(f"{url}/api/nodes")["nodes"]}
        version = _http_json(f"{url}/api/version")
        status = _cli(["status", "--address", gcs], env)
        log(f"[operator] head up in {res['head_ready_s']:.2f} s (start to /api/cluster "
            f"answering): GCS {gcs}, dashboard {url}, cluster {json.dumps(cluster)}, "
            f"version {version}; `status`: {status.splitlines()[0]} on {card}")
        if (cluster["nodes"] != 1 or cluster["cluster"]["total"].get("GPU", 0)
                or version != {"version": ray_tpu_torch.__version__}
                or "1 alive" not in status):
            raise AssertionError(f"the head: {cluster}, {version}, {status}")
        session_dir = json.loads((tmp / "cli_cluster.json").read_text())["nodes"][0][
            "session_dir"]

        # ---- 2. the autoscaler, one node type of one card
        node_types = {"gpu-node": NodeTypeConfig(resources=dict(OPERATOR_NODE),
                                                 max_workers=1)}
        provider = FakeMultiNodeProvider(gcs, {k: v.to_dict() for k, v in node_types.items()},
                                         session_dir=session_dir)
        marks = {}
        create = provider.create_node

        def timed_create(node_type, count=1):
            marks.setdefault("launch_at", time.time())
            return create(node_type, count)

        provider.create_node = timed_create
        scaler = Autoscaler(gcs, provider, node_types, update_interval_s=0.5,
                            idle_timeout_s=OPERATOR_IDLE_S)
        scaler.start()
        watching = threading.Event()
        seen = []

        def watch():   # when the card's node shows in /api/nodes, and goes
            while not watching.is_set():
                try:
                    nodes = _http_json(f"{url}/api/nodes", timeout=10)["nodes"]
                except Exception:
                    nodes = []
                gpu = [n for n in nodes if n["resources_total"].get("GPU")]
                if gpu and gpu[0]["state"] == "ALIVE" and "up_at" not in marks:
                    marks["up_at"] = time.time()
                    seen.append(gpu[0])
                    node_ids.add(gpu[0]["node_id"])
                # the raylet registers before create_node lists it: gone is
                # listed by the provider, then no longer
                listed = bool(provider.non_terminated_nodes())
                if listed and "up_at" in marks:
                    marks["listed"] = True
                if marks.get("listed") and "gone_at" not in marks and not listed:
                    marks["gone_at"] = time.time()
                    marks["gone_rows"] = gpu
                time.sleep(0.1)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()

        # ---- 3. the job, over HTTP
        entry = tmp / "operator_job.py"
        entry.write_text(OPERATOR_ENTRY)
        job_cfg = {"deadline_s": OPERATOR_DEADLINE_S}
        client = JobSubmissionClient(url)
        t0 = time.perf_counter()
        sid = client.submit_job(entrypoint=f"{sys.executable} {entry} {ROOT} "
                                           f"'{json.dumps(job_cfg)}'")
        deadline = time.time() + OPERATOR_DEADLINE_S
        while (st := client.get_job_status(sid)) not in (
                JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
            if time.time() > deadline:
                raise AssertionError(f"job {sid} still {st}: {client.get_job_logs(sid)}")
            time.sleep(0.2)
        res["job_s"] = time.perf_counter() - t0
        logs = _http_json(f"{url}/api/jobs/{sid}/logs")["logs"]
        if st != JobStatus.SUCCEEDED:
            raise AssertionError(f"job {sid} ended {st}: {logs[-4000:]}")
        job = json.loads(_job_lines(logs, "OPERATOR_RESULT")[-1])
        demand_at = float(_job_lines(logs, "DEMAND_AT")[-1])
        idle_at = float(_job_lines(logs, "IDLE_AT")[-1])
        deadline = time.time() + OPERATOR_DEADLINE_S
        while "gone_at" not in marks and time.time() < deadline:
            time.sleep(0.2)
        watching.set()
        watcher.join(timeout=10)
        if "up_at" not in marks or "gone_at" not in marks:
            raise AssertionError(f"the card's node: {marks}, seen {seen}")
        res.update(job, demand_to_node_up_s=marks["up_at"] - demand_at,
                   demand_to_launch_s=marks["launch_at"] - demand_at,
                   idle_to_node_gone_s=marks["gone_at"] - idle_at,
                   serve_tokens_per_s=serve["tokens_per_s"])
        log(f"[operator] job {sid} submitted over HTTP, SUCCEEDED in {res['job_s']:.2f} s "
            f"on {card}: {json.dumps(job)}")
        log(f"[operator] the job's GPT-2-124M actor: {job['tokens_per_s']:.1f} tokens/s "
            f"(model build {job['build_s']:.2f} s) beside the serve phase's in-process "
            f"{serve['tokens_per_s']:.1f} tokens/s; flash_attn_fwd launches "
            f"{job['launches']}, plain calls {job['plain_calls']}, worst greedy gap "
            f"{job['worst_gap']:.3g} against the card's plain forward (limit "
            f"{GREEDY_TOL}) on {card}")
        log(f"[operator] demand to the GPU node launched {res['demand_to_launch_s']:.2f} s, "
            f"to it ALIVE in /api/nodes {res['demand_to_node_up_s']:.2f} s; idle to "
            f"node gone {res['idle_to_node_gone_s']:.2f} s (idle timeout "
            f"{OPERATOR_IDLE_S} s); the node's row {json.dumps(seen[:1])} on {card}")
        deadline = time.time() + MULTINODE_DEATH_S   # the GCS marks it DEAD
        while True:
            gone = [n for n in _http_json(f"{url}/api/nodes")["nodes"]
                    if n["resources_total"].get("GPU")]
            if not any(n["state"] == "ALIVE" for n in gone) or time.time() > deadline:
                break
            time.sleep(0.2)
        res["idle_to_node_dead_s"] = time.time() - idle_at
        log(f"[operator] the node DEAD in /api/nodes {res['idle_to_node_dead_s']:.2f} s "
            f"after idle: {[n['state'] for n in gone]}")
        if job["width"] != list(SERVE_WIDTH) \
                or job["launches"] <= 0 or job["plain_calls"] \
                or job["launches"] != serve["launches"] \
                or job["worst_gap"] > GREEDY_TOL or not job["weights_equal"] \
                or job["cuda_visible_devices"] != "0" \
                or _job_lines(logs, "TORCH_IN_DRIVER") != ["False"]:
            raise AssertionError(f"the job's result: {job}, logs {logs[-2000:]}")
        if (not seen or seen[0]["resources_total"].get("GPU") != 1.0
                or res["idle_to_node_gone_s"] <= 0
                or any(n["state"] == "ALIVE" for n in gone)
                or provider.non_terminated_nodes()):
            raise AssertionError(f"the GPU node: seen {seen}, after {gone}")

        # ---- a long job, stopped by the CLI
        long_sid = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import time; print('LONG', flush=True); "
                       f"time.sleep(600)\"")
        deadline = time.time() + OPERATOR_DEADLINE_S
        while client.get_job_status(long_sid) != JobStatus.RUNNING:
            if time.time() > deadline:
                raise AssertionError(f"job {long_sid} never ran")
            time.sleep(0.2)
        t0 = time.perf_counter()
        _cli(["job", "--address", gcs, "stop", long_sid], env)
        while (st := client.get_job_status(long_sid)) != JobStatus.STOPPED:
            if time.time() > deadline:
                raise AssertionError(f"job {long_sid} still {st}")
            time.sleep(0.2)
        res["stop_s"] = time.perf_counter() - t0
        log(f"[operator] job {long_sid} RUNNING, `job stop` to STOPPED in "
            f"{res['stop_s']:.2f} s")

        # ---- 4. the perf gate writes a ledger of its own; history and the head read it
        t0 = time.perf_counter()
        report = _cli(["perf", "check", "--only", OPERATOR_PERF_ROWS, "--quick",
                       "--history", str(history), "--update"], env, timeout=600)
        res["perf_check_s"] = time.perf_counter() - t0
        hist = _cli(["perf", "history", "--history", str(history)], env)
        perf = _http_json(f"{url}/api/perf")
        rows = perf["history"][-1]["metrics"] if perf["history"] else {}
        log(f"[operator] perf check --only {OPERATOR_PERF_ROWS} --quick in "
            f"{res['perf_check_s']:.2f} s on {card}:\n{report.strip()}\n"
            f"[operator] perf history: {hist.strip()}\n[operator] /api/perf reads "
            f"{perf['path']}: {json.dumps(rows)}")
        if (perf["path"] != str(history) or len(perf["history"]) != 1
                or set(rows) != set(OPERATOR_PERF_ROWS.split(","))
                or not all(v > 0 for v in rows.values())):
            raise AssertionError(f"the perf ledger: {perf}")
        res["perf_rows"] = rows
    finally:
        # ---- 5. stop: no process of the phase and no plasma segment is left
        if url is not None:
            try:   # every node the head knows of, the dead one too
                node_ids |= {n["node_id"]
                             for n in _http_json(f"{url}/api/nodes")["nodes"]}
            except Exception:
                pass
        if scaler is not None:
            scaler.stop()
        if provider is not None:
            provider.shutdown()
        procs = []
        state_file = tmp / "cli_cluster.json"
        if state_file.exists():
            for node in json.loads(state_file.read_text()).get("nodes", []):
                for pid in node.get("pids", []):
                    try:
                        p = psutil.Process(pid)
                        procs += [p] + p.children(recursive=True)
                    except psutil.NoSuchProcess:
                        pass
            _cli(["stop"], env)
            stopped = True
        procs += script_children()
        gone, alive = psutil.wait_procs(procs, timeout=RUNTIME_STOP_S)
        for proc in alive:
            proc.kill()
        psutil.wait_procs(alive, timeout=10)
        left = _plasma_segments(node_ids)
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"[operator] stop: {len(gone)} of the phase's {len(procs)} processes left "
            f"within {RUNTIME_STOP_S} s, {len(alive)} killed; plasma segments of its "
            f"{len(node_ids)} nodes left {left}")
    if not stopped or alive or left or len(node_ids) != 2:
        raise AssertionError(f"stop left processes {[p.pid for p in alive]}, "
                             f"segments {left} of the nodes {sorted(node_ids)}")
    res["processes_stopped"] = len(gone)
    return res


def _trainer_ranks_loop(config):
    """The loop of ``--ranks``' trainer: every worker on its leased card, one
    NCCL group over them (brought up by ``TorchTrainer``); GPT-2-124M bf16
    on ``make_mesh({"dp": N})`` at the global TRAIN_BATCH, a warm-up and
    RANKS_TRAIN_STEPS timed steps with each step's counts, then one fp32
    4-layer step on the mesh against the one-device step on each card.
    Each rank's batches come from its shard of :func:`ranks_dataset`
    (``get_dataset_shard("train")``, B / N rows a step on its card); it
    reports the digest of every row it got. First, an all-reduce of 256 MB of fp32 over the trainer's group, as the
    ranks path times one over its own. Rank 0 reports what every rank saw."""
    import torch.distributed as dist

    device, start = _worker_start()
    world = dist.get_world_size()
    x = torch.ones(64 << 20, device=device)
    start["all_reduce_256mb_ms"] = cuda_ms(lambda: dist.all_reduce(x), iters=5, warmup=2)
    start["all_reduce_bus_gb_s"] = (2 * (world - 1) / world * x.numel() * 4
                                    / (start["all_reduce_256mb_ms"] / 1e3) / 1e9)
    del x
    from ray_tpu_torch import train as rtrain
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.train_step import TrainStep

    mesh = make_mesh({"dp": world}, device=device)
    cfg = GPT2Config.gpt2_124m()
    ts = TrainStep(cfg, mesh, device=device)
    state = ts.init(torch.Generator().manual_seed(0))
    it = rtrain.get_dataset_shard("train").iter_torch_batches(
        batch_size=TRAIN_BATCH[0] // world)
    losses, counts, step_ms, rows = [], [], [], []
    for _ in range(1 + RANKS_TRAIN_STEPS):
        batch = next(it)
        rows += _row_digests({k: v.cpu().numpy() for k, v in batch.items()})
        reset_counts()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(list(read_counts()))
        losses.append(m["loss"].item())
    if next(it, None) is not None:
        raise AssertionError("the shard holds more batches than the steps")
    del ts, state, batch
    torch.cuda.empty_cache()
    parity = mesh_parity(config["card"], f"gpt2-124m width on {{'dp': {world}}} "
                         "under TorchTrainer", GPT2Config.gpt2_124m(
                             n_layer=MESH_PARITY_LAYERS, dtype=torch.float32),
                         mesh, RANKS_PARITY_BATCH, RANKS_REL_TOL, tag="trainer_ranks")
    mine = {**start, "losses": losses, "counts": counts, "step_ms": step_ms,
            "n_layer": cfg.n_layer, "rows": rows,
            "parity": parity, "rank": dist.get_rank(), "backend": dist.get_backend()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    rtrain.report({"ranks": every})


def ranks_dataset(rd, vocab: int, world: int):
    """``--ranks N``'s Dataset: phase 7's TRAIN_BATCH once per step, in
    (1 + RANKS_TRAIN_STEPS) x N equal blocks, block s * N + r holding the
    rows rank r takes of step s's global batch (``split_blocks(N)`` gives
    rank r the blocks r, N + r, ...), mapped into idx / targets by tasks."""
    idx = np.random.default_rng(0).integers(0, vocab, TRAIN_BATCH)
    rows = np.concatenate([idx, idx[:, :1]], axis=1)
    steps = 1 + RANKS_TRAIN_STEPS
    return rd.from_numpy(np.tile(rows, (steps, 1)), column="tokens",
                         override_num_blocks=steps * world).map_batches(_split_tokens)


def trainer_ranks(card: str, world: int, dp_run, bus_gb_s):
    """``--ranks N``: ``TorchTrainer`` with N ``use_gpu`` workers, one card
    each, over the group its default ``TorchConfig`` picks for card workers
    (NCCL) (:func:`_trainer_ranks_loop`); checks distinct cards, 24 / 12 /
    12 launches and no plain call per rank and step, the losses against
    ``dp_run`` (the ranks path's run on the same ``{"dp": N}`` mesh, seed
    and batch) within TRAINER_LOSS_RTOL, and the fp32 step against one
    card. The batches come through ``datasets=`` (:func:`ranks_dataset`,
    equal blocks, a multiple of N): each rank's rows are disjoint from the
    others', and together they are the dataset's rows."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_ranks_")
    rt.init(num_cpus=world + 2)   # a CPU per worker's bundle, two for map tasks
    try:
        ds = ranks_dataset(rd, GPT2Config.gpt2_124m().vocab_size, world)
        t0 = time.time()
        result = TorchTrainer(
            _trainer_ranks_loop, train_loop_config={"card": card},
            scaling_config=ScalingConfig(num_workers=world, use_gpu=True),
            run_config=RunConfig(storage_path=scratch.name, name="trainer_ranks"),
            torch_config=TorchConfig(), datasets={"train": ds}).fit()
        fit_s = time.time() - t0
        dataset_rows = sorted(d for r in ds.take_all()
                              for d in _row_digests({k: [v] for k, v in r.items()}))
    finally:
        stop_runtime(rt)
        scratch.cleanup()
    every = result.metrics["ranks"]
    L = every[0]["n_layer"]
    want = [2 * L, L, L, 0]
    dp_median_ms, dp_losses = dp_run["median_step_ms"], dp_run["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(every[0]["losses"], dp_losses)]
    res = {"fit_s": fit_s, "cards": sorted(r["visible"] for r in every),
           "backends": sorted({r["backend"] for r in every}),
           "median_step_ms": [statistics.median(r["step_ms"][1:]) for r in every],
           "ranks_path_dp_median_ms": dp_median_ms,
           "all_reduce_bus_gb_s": [r["all_reduce_bus_gb_s"] for r in every],
           "ranks_path_all_reduce_bus_gb_s": bus_gb_s,
           "losses": every[0]["losses"], "ranks_path_dp_losses": dp_losses,
           "loss_max_rel_diff": max(rel),
           "launches": [sum(c[0] for c in r["counts"][1:]) for r in every],
           "launches_dq": [sum(c[1] for c in r["counts"][1:]) for r in every],
           "launches_dkv": [sum(c[2] for c in r["counts"][1:]) for r in every],
           "plain_calls": sum(c[3] for r in every for c in r["counts"]),
           "parity": [r["parity"] for r in every],
           "rows_disjoint": all(not set(a["rows"]) & set(b["rows"])
                                for i, a in enumerate(every) for b in every[i + 1:]),
           "rows_union_is_dataset": sorted(d for r in every for d in r["rows"])
                                    == dataset_rows,
           "startup": [{k: r[k] for k in ("import_torch_s", "cuda_context_s")}
                       for r in every]}
    log(f"[trainer_ranks] TorchTrainer over {world} cards ({res['backends']}): cards "
        f"{res['cards']}, median step per rank {[round(x, 2) for x in res['median_step_ms']]}"
        f" ms beside the ranks path's dp {world} median {dp_median_ms} ms; all-reduce "
        f"of 256 MB over the trainer's group {[round(x, 1) for x in res['all_reduce_bus_gb_s']]}"
        f" GB/s bus bandwidth beside the ranks path's {bus_gb_s} GB/s; "
        f"{json.dumps(res)} on {card}")
    if (res["cards"] != [str(i) for i in range(world)]
            or res["backends"] != ["nccl"]
            or not res["rows_disjoint"] or not res["rows_union_is_dataset"]
            or len(every[0]["losses"]) != len(dp_losses) or max(rel) > TRAINER_LOSS_RTOL
            or any(c != want for r in every for c in r["counts"])
            or any(r["visible"] is None or [r["visible"]] != r["accelerator_ids"]
                   or r["device_count"] != 1 for r in every)
            or not all(np.isfinite(res["losses"]))):
        raise AssertionError(f"the trainer over {world} cards: {res}")
    return res



def serve_ranks(world: int):
    """``--ranks N``: ``llm.deploy(model="gpt2", num_replicas=N)`` puts the
    N replicas on N distinct cards; 4 x 8 concurrent streams (the serve
    phase's prompts, four times) reach every replica, and every stream
    equals the one-replica deployment's (near-tie rule against the CPU)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    probe_cls = _deploy_probe_class()
    cpu = build_adapter("gpt2", seed=0, device="cpu")
    cpu_model = cpu.model
    prompts = serve_prompts(cpu.cfg.vocab_size)
    many = prompts * 4
    rt.init(num_cpus=4)
    try:
        deploy_probed(llm, probe_cls, model="gpt2", seed=0, app_name="one",
                      route_prefix="/one")
        one, _, one_wall = stream_all(llm, "one", prompts, SERVE_MAX_TOKENS)
        rt_serve.delete("one")
        h, deploy_s = deploy_probed(llm, probe_cls, model="gpt2", seed=0,
                                    num_replicas=world, app_name="all",
                                    route_prefix="/all")
        from ray_tpu_torch.serve._handle import CONTROLLER_NAME

        controller = rt.get_actor(CONTROLLER_NAME)
        names = rt.get(controller.get_replica_names.remote("all#LLMReplica"), timeout=60)
        starts = [rt.get(rt.get_actor(n).handle_request.remote("probe", (), {"reset": True}),
                         timeout=300) for n in names]
        outputs, ttft, wall = stream_all(llm, "all", many, SERVE_MAX_TOKENS)
        after = [rt.get(rt.get_actor(n).handle_request.remote("probe", (), {}),
                        timeout=60) for n in names]
    finally:
        try:
            rt_serve.shutdown()
        finally:
            stop_runtime(rt)
    ref = {i: one[i % len(prompts)] for i in range(len(many))}
    differ, worst = near_greedy(cpu_model, many, outputs, ref)
    cards = sorted(s["visible"] for s in starts)
    res = {"replicas": len(names), "cards": cards, "deploy_s": deploy_s,
           "launches_per_replica": [a["launches"] for a in after],
           "plain_calls": sum(a["plain_calls"] for a in after),
           "tokens_per_s": SERVE_MAX_TOKENS * len(many) / wall,
           "one_replica_tokens_per_s": SERVE_MAX_TOKENS * len(prompts) / one_wall,
           "ttft_s": [ttft[i] for i in sorted(ttft)],
           "streams_equal": len(many) - len(differ), "first_differences": differ,
           "worst_gap_after_difference": worst}
    log(f"[serve_ranks] {json.dumps(res)}")
    if (len(names) != world or cards != [str(i) for i in range(world)]
            or any(s["device_count"] != 1 for s in starts)
            or any(a["launches"] == 0 for a in after) or res["plain_calls"]
            or worst > GREEDY_TOL):
        raise AssertionError(f"{world} replicas on {world} cards: {res}")
    return res


class PairActor:
    """A ``num_gpus=2`` actor of ``--ranks``: what its lease lets it see."""

    def check(self):
        import os

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count()}


def runtime_ranks(world: int):
    """``--ranks N`` (N even): ``init`` sees the N cards, and N / 2 actors
    of ``num_gpus=2`` get disjoint pairs covering all of them, each seeing
    two cards."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        gpus = rt.cluster_resources().get("GPU", 0)
        actors = [rt.remote(num_gpus=2)(PairActor).remote() for _ in range(world // 2)]
        seen = rt.get([a.check.remote() for a in actors], timeout=300)
    finally:
        stop_runtime(rt)
    pairs = [set(s["visible"].split(",")) for s in seen]
    log(f"[runtime] {world} cards: the runtime detected {gpus} GPUs; "
        f"num_gpus=2 actors saw {seen}")
    if (gpus != world or any(len(p) != 2 for p in pairs)
            or set().union(*pairs) != {str(i) for i in range(world)}
            or any(s["device_count"] != 2 for s in seen)):
        raise AssertionError(f"GPU leases over {world} cards: {gpus} GPUs, {seen}")
    return {"gpus": gpus, "pairs": [s["visible"] for s in seen]}


def _padded_learner_classes(world: int):
    """(TorchLearner, DQNLearner) subclasses on one device that pad every
    minibatch to a multiple of ``world`` as a ``world``-rank dp learner does
    and keep every row: the one-card reference of :func:`learner_ranks`."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.core.learner import DataParallel, TorchLearner

    class PadTo(DataParallel):
        def __init__(self):
            super().__init__(None, torch.device("cpu"))

        def pad(self, t, axis: int = 0):
            pad = (-t.shape[axis]) % world
            if not pad:
                return t
            shape = list(t.shape)
            shape[axis] = pad
            last = t.narrow(axis, t.shape[axis] - 1, 1)
            return torch.cat([t, last.expand(*shape)], dim=axis)

    class PaddedTorchLearner(TorchLearner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.dp = PadTo()

    class PaddedDQNLearner(DQNLearner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.dp = PadTo()

    return PaddedTorchLearner, PaddedDQNLearner


def _rank_view(rank):
    """A dp learner rank's card, group and parameters' device."""
    import os

    import torch.distributed as dist

    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "backend": dist.get_backend(),
            "rank": dist.get_rank(), "world": dist.get_world_size(),
            "device": str(next(rank.learner.module.parameters()).device)}


def _tree_digest(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        h.update(_tree_digest(v).encode() if isinstance(v, dict)
                 else np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _tree_leaves(tree):
    return ([x for k in sorted(tree) for x in _tree_leaves(tree[k])]
            if isinstance(tree, dict) else [np.asarray(tree, np.float64)])


def learner_ranks(card: str, world: int):
    """``--ranks N``: a LearnerGroup of N dp learner ranks (one card each,
    NCCL) against a one-card learner (mesh_devices=1) padding to N, on one
    fixed CartPole-v1 batch: PPO's update_from_batch (odd minibatches) and
    DQN's update, aux within RL_REL_TOL relative, parameters within
    RL_REL_TOL relative or 2·lr (under 1% of them), the ranks' parameters
    bitwise equal; each update's ms (the group's call from the driver,
    warm) on one card and on N."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.algorithms import dqn
    from ray_tpu_torch.rllib.core.learner import LearnerGroup, TorchLearner
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    padded_ppo, padded_dqn = _padded_learner_classes(world)
    w0 = TorchLearner(4, 2, device="cpu").get_weights()
    batch = SingleAgentEnvRunner("CartPole-v1", 8, gamma=0.99, lambda_=0.95,
                                 seed=0).sample(w0, 64)
    batch.pop("episode_returns")
    q0 = dqn.DQNLearner(4, 2, device="cpu").get_weights()
    q_batch = dqn.DQNEnvRunner("CartPole-v1", 8, seed=1).sample(q0, 32, 1.0)
    q_batch.pop("episode_returns")
    q_batch = {k: v[:RL_DP_DQN_ROWS] for k, v in q_batch.items()}
    cases = (("ppo", 1e-3, TorchLearner, padded_ppo, w0,
              lambda g: g.update_from_batch(batch, **RL_DP_PPO)),
             ("dqn", 1e-3, dqn.DQNLearner, padded_dqn, q0, lambda g: g.call("update", q_batch)))
    out = {"batch_rows": len(batch["obs"]), "dqn_rows": RL_DP_DQN_ROWS, "ppo": RL_DP_PPO}
    rt.init(num_cpus=world + 2)
    try:
        gpus = rt.cluster_resources().get("GPU", 0)
        if gpus != world:
            raise AssertionError(f"the runtime sees {gpus} GPUs, not {world}")
        for name, lr, cls, padded, weights, update in cases:
            runs = {}
            for d, learner_cls in ((1, padded), (world, cls)):
                t0 = time.perf_counter()
                group = LearnerGroup(4, 2, config={"mesh_devices": d, "num_gpus_per_learner": 1,
                                                   "lr": lr}, learner_cls=learner_cls)
                start_s = time.perf_counter() - t0
                try:
                    ms = []
                    for _ in range(2):   # the first pays the ranks' first launches
                        group.set_weights(weights)
                        t0 = time.perf_counter()
                        aux = update(group)
                        ms.append((time.perf_counter() - t0) * 1e3)
                    ranks = group._ranks or [group._actor]
                    params = rt.get([r.call.remote("get_weights") if group._ranks
                                     else r.get_weights.remote() for r in ranks], timeout=120)
                    views = (rt.get([r.__ray_call__.remote(_rank_view) for r in group._ranks],
                                    timeout=60) if group._ranks else [])
                finally:
                    group.shutdown()
                runs[d] = {"aux": aux, "params": params[0], "first_ms": ms[0], "ms": ms[1],
                           "start_s": start_s, "views": views,
                           "ranks_bitwise": len({_tree_digest(p) for p in params}) == 1}
            one, many = runs[1], runs[world]
            aux_err = max(abs(many["aux"][k] - one["aux"][k]) / max(abs(one["aux"][k]),
                                                                    RL_ABS_FLOOR / RL_REL_TOL)
                          for k in one["aux"])
            leaves = list(zip(_tree_leaves(many["params"]), _tree_leaves(one["params"])))
            p_err = max(float(np.abs(a - b).max()) for a, b in leaves)
            outliers = sum(int((np.abs(a - b) > RL_REL_TOL * np.abs(b) + RL_ABS_FLOOR).sum())
                           for a, b in leaves)
            size = sum(b.size for _, b in leaves)
            views = many["views"]
            res = {"one_card_ms": one["ms"], "ranks_ms": many["ms"],
                   "one_card_first_ms": one["first_ms"], "ranks_first_ms": many["first_ms"],
                   "one_card_start_s": one["start_s"], "ranks_start_s": many["start_s"],
                   "aux": many["aux"], "aux_max_rel_err": aux_err, "param_max_abs_err": p_err,
                   "param_outliers": outliers, "params": size, "lr": lr,
                   "ranks_bitwise": many["ranks_bitwise"], "rank_views": views}
            log(f"[ranks] LearnerGroup {name} at mesh_devices={world} (ranks: "
                f"{[(v['rank'], v['visible'], v['backend'], v['device']) for v in views]}, "
                f"started in {many['start_s']:.2f} s) against one card padding to {world}: "
                f"aux largest relative difference {aux_err:.3g} (limit {RL_REL_TOL}), "
                f"parameters largest difference {p_err:.3g} (limit 2·lr {2 * lr:g}), "
                f"{outliers} of {size} beyond {RL_REL_TOL} relative, ranks bitwise equal "
                f"{many['ranks_bitwise']}; the update {one['ms']:.2f} ms on one card, "
                f"{many['ms']:.2f} ms on {world} (first {one['first_ms']:.2f} / "
                f"{many['first_ms']:.2f} ms) on {card}")
            if (aux_err > RL_REL_TOL or p_err > 2 * lr + 1e-6 or outliers > 0.01 * size
                    or not many["ranks_bitwise"] or len(views) != world
                    or sorted(v["rank"] for v in views) != list(range(world))
                    or len({v["visible"] for v in views}) != world
                    or any(v["backend"] != "nccl" or v["device"] != "cuda:0" for v in views)):
                raise AssertionError(f"the dp learner ({name}): {res}")
            out[name] = res
    finally:
        stop_runtime(rt)
    return out


def phase_ranks(card: str, world: int, pipe_ref):
    """This rank's part of ``--ranks``: the one-device GPT-2-124M step on
    its card, then GPT-2-124M on each mesh of RANKS_TRAIN_MESHES, then the
    fp32 mesh steps against the one-device step (RANKS_PARITY_MESHES); then
    GPT-2-MoE alone on its card and on each mesh of RANKS_MOE_MESHES (fp32
    parity too), the pipeline on each mesh of RANKS_PIPE_MESHES beside
    ``pipe_ref``, the one-card run of :func:`pipeline_reference`, and
    GPT-2 with 2 heads over tp = 4 (fault 3) against one card."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    keep = ("step_ms", "median_step_ms", "median_tokens_per_s", "losses", "grad_norms",
            "launches", "plain_calls", "launches_per_step", "summary", "exact_mfu",
            "kernel_ms_profiled", "device_busy_share", "idle_gap_ms")
    # the interconnect: an all-reduce of 256 MB of fp32 over every rank
    x = torch.ones(64 << 20, device=DEVICE)
    ms = cuda_ms(lambda: torch.distributed.all_reduce(x), iters=5, warmup=2)
    bus = 2 * (world - 1) / world * x.numel() * 4 / (ms / 1e3) / 1e9
    log(f"[ranks] all_reduce of 256 MB fp32 over {world} cards: {ms:.3f} ms, "
        f"{bus:.1f} GB/s bus bandwidth (2 (n - 1) / n x bytes / time) on {card}")
    del x
    single = train_run(card, "ranks", "gpt2-124m, one device", GPT2Config.gpt2_124m(),
                       TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True)
    out = {"world_size": world, "all_reduce_256mb_ms": ms, "all_reduce_bus_gb_s": bus,
           "one_device": {k: single[k] for k in keep}, "meshes": {}, "parity": {}}
    for axes in RANKS_TRAIN_MESHES:
        run = train_run(card, "ranks", f"gpt2-124m on {axes}", GPT2Config.gpt2_124m(),
                        TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True,
                        mesh=make_mesh(axes, device=DEVICE))
        log(f"[ranks] {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms, {run['median_tokens_per_s']:.0f} tokens/s "
            f"(global batch {TRAIN_BATCH}) beside one card's {single['median_step_ms']:.2f}"
            f" ms, {single['median_tokens_per_s']:.0f} tokens/s, on {card} each")
        out["meshes"][json.dumps(axes)] = {k: run[k] for k in keep}
    fp32 = dict(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32)
    for axes in RANKS_PARITY_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        for name, cfg in (("gpt2-124m", GPT2Config.gpt2_124m(**fp32)),
                          ("llama-160m", LlamaConfig.llama_160m(**fp32))):
            out["parity"][f"{name} {json.dumps(axes)}"] = mesh_parity(
                card, f"{name} on {axes}", cfg, mesh, RANKS_PARITY_BATCH, RANKS_REL_TOL)

    # GPT-2-MoE: one card alone, then the ep meshes, each with fp32 parity
    moe = train_run(card, "ranks", "gpt2-moe, one device", GPT2MoEConfig(),
                    MOE_TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True)
    out["moe_one_device"] = {k: moe[k] for k in keep}
    out["moe_meshes"] = {}
    for axes in RANKS_MOE_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        run = train_run(card, "ranks", f"gpt2-moe on {axes}", GPT2MoEConfig(),
                        MOE_TRAIN_BATCH, RANKS_TRAIN_STEPS, profiled=True, mesh=mesh)
        log(f"[ranks] gpt2-moe on {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms beside one card's {moe['median_step_ms']:.2f} "
            f"ms (global batch {MOE_TRAIN_BATCH}), on {card} each")
        out["moe_meshes"][json.dumps(axes)] = {k: run[k] for k in keep}
        out["parity"][f"gpt2-moe {json.dumps(axes)}"] = mesh_parity(
            card, f"gpt2-moe on {axes}", GPT2MoEConfig(**fp32), mesh, RANKS_PARITY_BATCH,
            RANKS_REL_TOL, tag="ranks")

    # the pipeline at GPT-2-124M width, beside and against one card's
    ref = (pipe_ref["loss"], pipe_ref["grad_norm"], torch.load(pipe_ref["path"]))
    out["pipeline_meshes"] = {}
    for axes in RANKS_PIPE_MESHES:
        mesh = make_mesh(axes, device=DEVICE)
        run = pipeline_run(card, "ranks", f"gpt2-124m pipeline on {axes}",
                           GPT2Config.gpt2_124m(), mesh, PIPE_BATCH, RANKS_TRAIN_STEPS)
        log(f"[ranks] gpt2-124m pipeline on {axes} over {world} cards: median step "
            f"{run['median_step_ms']:.2f} ms beside one card's "
            f"{pipe_ref['median_step_ms']:.2f} ms (global batch {PIPE_BATCH}), on {card} each")
        out["pipeline_meshes"][json.dumps(axes)] = run
        got = pipeline_step(GPT2Config.gpt2_124m(**fp32), mesh, 2, DEVICE, RANKS_PARITY_BATCH)
        out["parity"][f"pipeline {json.dumps(axes)}"] = pipeline_compare(
            "ranks", f"on {axes} vs one card", got, ref, RANKS_REL_TOL)
    del ref

    # fault 3 on the cards: a head computed by tp / n_head ranks alike
    axes, heads = RANKS_FAULT3
    out["parity"][f"gpt2-124m-width {heads} heads {json.dumps(axes)}"] = mesh_parity(
        card, f"gpt2-124m width, {heads} heads, on {axes}",
        GPT2Config.gpt2_124m(n_head=heads, use_flash_attention=False, **fp32),
        make_mesh(axes, device=DEVICE), RANKS_PARITY_BATCH, RANKS_REL_TOL, tag="ranks")
    return out


def pipeline_reference(card: str, path: str):
    """One card alone, before ``--ranks`` starts its processes: the
    pipeline's GPT-2-124M run at dp 1 x pp 1 (its median step is what the
    pp meshes are timed beside) and the fp32 4-layer step (1 microbatch)
    they are held to, its parameters saved to ``path``. Starts and ends its
    own one-process NCCL group."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(PIPE_AXES, device=DEVICE)
    run = pipeline_run(card, "ranks", "gpt2-124m pipeline, one card",
                       GPT2Config.gpt2_124m(), mesh, PIPE_BATCH, RANKS_TRAIN_STEPS,
                       PIPE_MICRO)
    loss, norm, params = pipeline_step(
        GPT2Config.gpt2_124m(n_layer=MESH_PARITY_LAYERS, dtype=torch.float32), mesh, 1,
        DEVICE, RANKS_PARITY_BATCH)
    torch.save(params, path)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"median_step_ms": run["median_step_ms"], "step_ms": run["step_ms"],
            "loss": loss, "grad_norm": norm, "path": path}


def _rank_main(rank: int, world: int, port: int, card: str, device: str, results,
               pipe_ref):
    """One process of ``--ranks``: its card, NCCL over ``tcp://localhost``."""
    import torch.distributed as dist

    global DEVICE, LOG
    DEVICE, LOG = device, rank == 0
    try:
        sys.path.insert(0, str(ROOT))
        from ray_tpu_torch._private.device import set_fp32_policy

        if device == "cuda":
            torch.cuda.set_device(rank)
            set_fp32_policy()
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        results.put((rank, "ok", phase_ranks(card, world, pipe_ref)))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def main_ranks(world: int) -> int:
    """``--ranks N``: the mesh path over N cards, one process each."""
    import multiprocessing as mp
    import queue

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke.py --ranks {world} needs {world} CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)

    import tempfile

    from ray_tpu_torch._private.device import set_fp32_policy

    set_fp32_policy()
    card = phase_device()
    phase_build()
    scratch = tempfile.TemporaryDirectory()
    pipe_ref = pipeline_reference(card, str(Path(scratch.name) / "pipeline_ref.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, card, DEVICE, results, pipe_ref))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + RANKS_DEADLINE_S
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} gave "
                                     f"nothing within {RANKS_DEADLINE_S} s") from None
            if status == "error":
                raise AssertionError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:   # a failed or hung rank's peers wait in collectives
            if p.is_alive():
                p.kill()
            p.join()
        scratch.cleanup()
    got[0]["pipeline_one_card"] = {k: v for k, v in pipe_ref.items() if k != "path"}
    dp = got[0]["meshes"][json.dumps({"dp": world})]
    got[0]["trainer"] = trainer_ranks(card, world, dp, got[0]["all_reduce_bus_gb_s"])
    got[0]["learner"] = learner_ranks(card, world)
    got[0]["runtime"] = runtime_ranks(world)
    got[0]["serve"] = serve_ranks(world)
    log(f"[ranks] {json.dumps(got[0])}")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout)
    from ray_tpu_torch._private.device import set_fp32_policy

    set_fp32_policy()
    card = phase_device()
    phase_build()
    fwd_cases = phase_kernel(card)
    bwd_cases = phase_bwd(card)
    phase_model(card)
    serve = phase_serve(card)
    train = phase_train(card)
    llama = phase_llama(card)
    llama_cpu = llama.pop("cpu_model")
    spec = phase_spec(card, llama["prompts"], llama["outputs"], llama_cpu)
    moe = phase_moe(card)
    head_dims = phase_head_dims(card)
    mesh = phase_mesh(card, train)
    moe_mesh = phase_moe_mesh(card, moe)
    pipeline = phase_pipeline(card)
    torch.distributed.destroy_process_group()
    runtime = phase_runtime(card, serve, train)
    serve_deploy = phase_serve_deploy(card, serve, runtime, spec, llama["prompts"],
                                      llama_cpu)
    trainer = phase_trainer(card, train)
    data = phase_data(card, train)
    rllib = phase_rllib(card)
    multinode = phase_multinode(card, serve, runtime)
    dag, wf = phase_graphs(card)
    operator = phase_operator(card, serve)
    del llama_cpu
    spec.pop("same_seed_outputs")
    for key in ("prompts", "outputs", "cpu_model"):
        serve.pop(key)

    fwd_head = next(c for c in fwd_cases if "ms" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))
    bwd_head = next(c for c in bwd_cases if "dq" in c and c["shape"] == list(HEADLINE[0])
                    and c["dtype"] == dtype_name(HEADLINE[1]))

    fp32_prompt = next(c for c in fwd_cases if "ms" in c and c["dtype"] == "float32"
                       and c["shape"] == [1, 12, max(SERVE_PROMPT_LENS), 64])
    at = {"shape": list(HEADLINE[0]), "dtype": dtype_name(HEADLINE[1])}
    # plain attention calls on each full-width path: all must be 0
    plain_calls = {"train": train["plain_calls"], "serve": serve["plain_calls"],
                   "llama_train": llama["train"]["plain_calls"],
                   "llama_serve": llama["serve_plain_calls"],
                   "spec": spec["plain_calls"], "moe_train": moe["plain_calls"],
                   "mesh": mesh["plain_calls"], "moe_mesh": moe_mesh["plain_calls"],
                   "pipeline": pipeline["plain_calls"],
                   "runtime_serve": runtime["serve_plain_calls"],
                   "runtime_train": runtime["train_plain_calls"],
                   "serve_deploy": serve_deploy["plain_calls"],
                   "serve_deploy_spec": serve_deploy["spec"]["plain_calls"],
                   "serve_deploy_after_close":
                       serve_deploy["after_close"]["plain_calls"],
                   "trainer": trainer["plain_calls"],
                   "data": data["plain_calls"],
                   "multinode_pool": multinode["pool_plain_calls"],
                   "multinode_grads": multinode["grads_plain_calls"],
                   "dag_stage_a": dag["plain_calls_a"], "dag_stage_b": dag["plain_calls_b"],
                   "workflow": wf["plain_calls"], "operator": operator["plain_calls"]}
    if any(plain_calls.values()):
        raise AssertionError(f"a full-width path left the kernels: {plain_calls}")
    fp32_bwd = [c for c in bwd_cases if c["dtype"] == "float32"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:42",
        "launches": train["launches"][0],
        "launches_by_path": {"train": train["launches"][0], "serve": serve["launches"],
                             "llama_train": llama["train"]["launches"][0],
                             "llama_serve": llama["serve_launches"],
                             "spec": spec["launches"],
                             "moe_train": moe["launches"][0],
                             "mesh": mesh["launches"][0],
                             "moe_mesh": moe_mesh["launches"][0],
                             "pipeline": pipeline["launches"][0],
                             "runtime_serve": runtime["serve_launches"],
                             "runtime_train": runtime["train_launches"][0],
                             "serve_deploy": serve_deploy["launches"],
                             "serve_deploy_spec": serve_deploy["spec"]["launches"],
                             "serve_deploy_after_close":
                                 serve_deploy["after_close"]["launches"],
                             "trainer": trainer["launches"][0],
                             "data": data["launches"][0],
                             "multinode_pool": multinode["pool_launches"],
                             "multinode_grads": multinode["grads_launches"][0],
                             "dag_stage_a": dag["launches_a"],
                             "dag_stage_b": dag["launches_b"],
                             "workflow": wf["launches"],
                             "operator": operator["launches"]},
        "max_abs_err": max(max(c["err_o"], c["err_lse"]) for c in fwd_cases
                           if c["dtype"] == "float32"),
        "max_abs_err_by_dtype": {dt: max(max(c["err_o"], c["err_lse"]) for c in fwd_cases
                                         if c["dtype"] == dt)
                                 for dt in ("float32", "bfloat16")},
        "ms": fwd_head["ms"],
        "plain_ms": fwd_head["plain_ms"],
        "bound_ms": fwd_head["bound_ms"],
        "bound_by": fwd_head["bound_by"],
        "library_ms": fwd_head["library_ms"],
        "plain_calls_by_path": plain_calls,
        "design": DESIGN["flash_attn_fwd"],
        "tflops": fwd_head["tflops"],
        "bound_share": fwd_head["bound_share"],
        "at": dict(at, max_abs_err_over="o and lse, every fp32 case",
                   library="SDPA forward"),
        # the fp32 design at the serve phase's longest prompt
        "fp32_prompt": {key: fp32_prompt[key] for key in
                        ("shape", "design", "block_m", "grid", "ms", "ms_device",
                         "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "library_ms_device", "bound_share", "ms_by_block_m",
                         "device_ms_by_block_m")},
        "cases": fwd_cases,
    }]
    for name, kernel, outputs, line in (("flash_attn_bwd_dq", "dq", ("dq",), 114),
                                        ("flash_attn_bwd_dkv", "dkv", ("dk", "dv"), 146)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            "launches": train["launches"][1 if kernel == "dq" else 2],
            "launches_by_path": {path: run["launches"][1 if kernel == "dq" else 2]
                                 for path, run in (("train", train),
                                                   ("llama_train", llama["train"]),
                                                   ("moe_train", moe),
                                                   ("mesh", mesh),
                                                   ("moe_mesh", moe_mesh),
                                                   ("pipeline", pipeline),
                                                   ("runtime_train",
                                                    {"launches": runtime["train_launches"]}),
                                                   ("trainer", trainer),
                                                   ("data", data),
                                                   ("multinode_grads",
                                                    {"launches": multinode["grads_launches"]}))},
            "max_abs_err": max(c["abs_err"][o] for c in fp32_bwd for o in outputs),
            "max_abs_err_by_dtype": {dt: max(c["abs_err"][o] for c in bwd_cases
                                             if c["dtype"] == dt for o in outputs)
                                     for dt in ("float32", "bfloat16")},
            "ms": bwd_head[kernel]["ms"],
            "plain_ms": bwd_head["plain_ms"],
            "bound_ms": bwd_head[kernel]["bound_ms"],
            "bound_by": bwd_head[kernel]["bound_by"],
            "library_ms": bwd_head["library_ms"],
            "plain_calls_by_path": {path: plain_calls[path] for path in
                                    ("train", "llama_train", "moe_train", "mesh",
                                     "moe_mesh", "pipeline", "runtime_train", "trainer",
                                     "data", "multinode_grads")},
            "design": DESIGN[name],
            "tflops": bwd_head[kernel]["tflops"],
            "bound_share": bwd_head[kernel]["bound_share"],
            "at": dict(at, max_abs_err_over=f"{'/'.join(outputs)}, every fp32 case",
                       plain="plain_causal_attention_bwd: dq, dk and dv together",
                       library="autograd.grad of an SDPA output: dq, dk and dv "
                               "together",
                       pair_ms=bwd_head["dq"]["ms"] + bwd_head["dkv"]["ms"],
                       whole_backward_ms=bwd_head["bwd_ms"]),
        })
    kernels[1]["cases"] = bwd_cases
    log(f"[train] {json.dumps(train)}")
    llama.pop("prompts")
    llama.pop("outputs")
    log(f"[llama] {json.dumps(llama)}")
    log(f"[spec] {json.dumps(spec)}")
    log(f"[moe] {json.dumps(moe)}")
    log(f"[serve] {json.dumps(serve)}")
    log(f"[head_dims] {json.dumps(head_dims)}")
    log(f"[mesh] {json.dumps(mesh)}")
    log(f"[moe_mesh] {json.dumps(moe_mesh)}")
    log(f"[pipeline] {json.dumps(pipeline)}")
    log(f"[runtime] {json.dumps(runtime)}")
    log(f"[serve_deploy] {json.dumps(serve_deploy)}")
    log(f"[trainer] {json.dumps(trainer)}")
    log(f"[data] {json.dumps(data)}")
    log(f"[rllib] {json.dumps(rllib)}")
    log(f"[multinode] {json.dumps(multinode)}")
    log(f"[dag] {json.dumps(dag)}")
    log(f"[workflow] {json.dumps(wf)}")
    log(f"[operator] {json.dumps(operator)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_prefills(root: str) -> int:
    """The serve and llama phases' serving runs alone (``serve_run`` on
    GPT-2-124M and Llama-160M, fp32, with their checks), on the package of
    the tree at ``root``: this checkout, or an unpacked archive of another
    commit, so that two commits' cold prefills are timed by the same code on
    one card (run them parent, change, change, parent). Prints each cold
    prefill's synchronised ms and a JSON line of them. A cold prefill meets
    each prompt length once, so its ms also holds first-use costs; beside
    them, the model's fp32 forward over one prompt of PREFILL_WARM_LENS
    tokens, warm: window ms (``cuda_ms``), the device's kernel ms of one call
    (``device_ms``) and the attention kernel's share of it."""
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(root).resolve()))
    import ray_tpu_torch
    from ray_tpu_torch._private.device import set_fp32_policy
    from ray_tpu_torch.ops import _cuda
    from ray_tpu_torch.serve.llm.adapters import build_adapter

    set_fp32_policy()
    card = phase_device()
    _cuda.build(["flash_attn_fwd"])
    out = {"package": str(Path(ray_tpu_torch.__file__).parent), "card": card}
    for tag, model in (("serve", "gpt2"), ("llama", "llama-160m")):
        adapter = build_adapter(model, seed=0, device=DEVICE)
        run = serve_run(card, tag, adapter)
        out[tag] = {"cold_prefill_ms": {n: ms for n, start, ms in run["prefills"]
                                        if start == 0},
                    "launches": run["launches"], "plain_calls": run["plain_calls"],
                    "tokens_per_s": run["tokens_per_s"], "warm_forward": {}}
        gen = torch.Generator().manual_seed(2)
        for n in PREFILL_WARM_LENS:
            idx = torch.randint(0, adapter.cfg.vocab_size, (1, n), generator=gen).to(DEVICE)
            with torch.inference_mode():
                forward = lambda: adapter.model(idx)
                warm = {"ms": cuda_ms(forward, iters=10, warmup=3),
                        "device_ms": device_ms(forward, iters=10, warmup=3),
                        "attention_device_ms": device_ms(forward, "flash_fwd",
                                                         iters=10, warmup=3)}
            out[tag]["warm_forward"][n] = warm
            log(f"[{tag}] warm fp32 forward of {n} tokens: {warm['ms']:.3f} ms "
                f"(device {warm['device_ms']:.3f}, of it attention "
                f"{warm['attention_device_ms']:.3f}) on {card}")
        del run, adapter
        torch.cuda.empty_cache()
    log(json.dumps({"prefills": out}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(main_ranks(int(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--prefills":
        sys.exit(main_prefills(sys.argv[2]))
    sys.exit(main())
