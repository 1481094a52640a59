"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A second package beside ``ray_tpu``, which stays the JAX reference. The
port imports ``torch`` and numpy and nothing of JAX or of ``ray_tpu``: the
device-free pieces it needs (the LLM scheduler, the KV-cache bookkeeping,
the engine's config defaults) are copied into it. Every Pallas kernel of
the JAX package on a ported path becomes a kernel written by hand for the
H100 (``csrc/``, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use),
with its plain PyTorch version beside it.

What is ported so far (the serving and training slices, every model
family of the JAX zoo, speculative decoding, the metrics and the flight
recorder, the training step on a mesh of dp, fsdp, tp, sp, ep and pp, the
runtime's core, the serve deployment on it, the trainer with Tune and
placement groups, data, RLlib with its dp learner over several cards,
several nodes on one machine with the rest of ``util``, compiled
graphs with workflows, and the operator plane):

  api.py, actor.py,      init / remote / get / put / wait / kill / shutdown,
  remote_function.py,    actors and tasks with ``num_gpus`` (copies of the
  runtime_context.py     JAX runtime's, GPUs where it has TPU chips),
                         loaded lazily from this package
  _private/              the runtime's core (copies): ids, rpc, the GCS,
                         the raylet (per-lease CUDA_VISIBLE_DEVICES), the
                         fork server and workers, the CoreWorker,
                         serialization (torch tensors by way of numpy,
                         out of band), the memory store, reference
                         counting, the flags as RTPU_TORCH_*; GPU
                         detection without CUDA (accelerators.py)
  _native/plasma.py      the shared-memory object store, C++ built at
                         first use

  ops/attention.py       causal attention, differentiable; where the kernels
                         take the head dim (32, 64, 128) and type, on a CUDA
                         tensor the flash forward kernel
                         ``csrc/flash_attn_fwd.cu`` (the port of
                         ``_fwd_kernel``) and the dq and dk/dv backward
                         kernels ``csrc/flash_attn_bwd.cu`` (the ports of
                         ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), on a
                         CPU tensor their plain versions; elsewhere the
                         einsum path, counted on the card
  ops/moe.py             MoE FFN: static-capacity top-k routing, the
                         Switch load-balance loss, dispatch/combine einsums
  ops/ring_attention.py  causal attention over the sp ranks: k/v round a
                         ring of ppermutes, a log-space streaming merge
  models/gpt2.py         GPT-2 as an ``nn.Module`` (fp32 parameters, compute
  models/llama.py        in ``config.dtype``, per-block checkpointing);
  models/gpt2_moe.py     Llama (RMSNorm, RoPE, GQA, SwiGLU, fp32 head);
                         GPT-2-MoE; each with flax weight and train-state
                         loaders (``models/_flax.py``)
  parallel/train_step.py TrainStep for GPT2Config, LlamaConfig and
                         GPT2MoEConfig on one device, and for GPT-2 and
                         Llama on a mesh (FSDP2 over dp/fsdp/sp, Megatron
                         tp, ring attention over sp): AdamW with optax's
                         clip and weight-decay mask, the MoE aux loss,
                         step / multi_step
  parallel/mesh.py       make_mesh (a DeviceMesh), the port's PartitionSpec,
                         ShardingRules, batch_sharding
  parallel/_collectives.py  ppermute and Megatron's copy / reduce pair, with
                         their gradients
  train/_telemetry.py    StepRecorder: goodput, tokens/s, MFU, HBM, the
                         ray_tpu_train_* series, slow-step and compile-storm
                         flags, a torch.profiler device-trace window
  util/metrics.py        Counter, Gauge, Histogram over a process-global
                         record table (drain_records)
  _private/flight_recorder.py  per-process ring of structured events
                         (train.step, llm.*)
  serve/llm/             LLM engine with prefix caching and speculative
                         decoding (``draft_adapter``/``spec_k``), its
                         ray_tpu_llm_* series and llm.* events, scheduler,
                         paged KV cache on the device, GPT-2, GPT-2-MoE,
                         Llama and fake adapters (zoo: gpt2-tiny, gpt2,
                         gpt2-moe-tiny, llama-tiny, llama-160m, fake);
                         LLMReplica and llm.deploy / stream / generate
  serve/                 the serve deployment on the runtime (copies): the
                         controller, replicas, handles with pow-2 routing,
                         the HTTP proxy, the binary RPC ingress with its
                         out-of-band LLM token frames, batching,
                         multiplexing, autoscaling; one leased card per
                         LLM replica, torch only in the replicas
  train/                 TorchTrainer: fit() as a one-trial Tune run, one
                         worker per {"GPU": 1, "CPU": 1} bundle on its
                         leased card, one torch.distributed group over the
                         workers (NCCL on cards); reports, checkpoints,
                         group restart (copies of the JAX package's Train)
  tune/                  Tuner, search spaces, TPE, ASHA, HyperBand, median
                         stopping, PBT (copies)
  util/placement_group.py  gang reservation of resource bundles
  data/                  Dataset: lazy plans of map stages over numpy blocks
                         in plasma, the streaming executor with
                         backpressure, the sort / groupby / shuffle exchange,
                         readers, preprocessors (copies); torch only in
                         iter_torch_batches, which places batches on the card
                         through pinned memory and non-blocking copies
  rllib/                 RL: CPU env-runner actors (numpy copies of the
                         policy and of CartPole-v1 / Pendulum-v1) feeding
                         learners on leased cards: PPO, IMPALA, APPO, DQN,
                         SAC, multi-agent PPO, BC, MARWIL, offline data;
                         a dp learner of one process per card (NCCL)
  cluster_utils.py       Cluster: several raylets on one machine under one
                         GCS, each with the resources it is given (copies)
  util/                  broadcast_object (tree fan-out of raylet pushes),
                         the state API (list_* and the memory report),
                         ActorPool, Queue, Pool, inspect_serializability,
                         the client and its server, OpenLoopLoadGen, and
                         collective: the host plane's TCP ring, with torch
                         tensors on any device (NCCL stays
                         torch.distributed's, in parallel/)
  dag/                   .bind() nodes, eager execute, CompiledDAG: actor
                         exec loops (on the actor's card) over channels
  experimental/channel.py  shared-memory channels mutated in place in
                         plasma, socket channels between nodes (copies);
                         a CUDA tensor crosses as its host copy
  workflow/              durable DAG execution with resume, virtual actors
                         (copies, the JAX storage layout)
  dashboard/             the HTTP head (state, jobs, logs, profiles, perf,
                         memory, train / serve telemetry; GPUs on its page
                         and in its Grafana dashboard) and the node agent
  job_submission/        JobSubmissionClient (GCS or the head's REST) and
                         the JobSupervisor actor running an entrypoint as
                         a subprocess with RTPU_TORCH_ADDRESS set
  autoscaler/            the demand scheduler and control loop, node
                         providers (fake multi-node, command, GCP TPU VMs),
                         and the YAML launcher (``up`` / ``down``)
  scripts.py             the operator CLI ``ray-tpu-torch``: start, stop,
                         up, down, status, job, perf, lint, ... (copies)
  _private/perf_gate.py  the perf gate over the port's microbench
                         (_private/microbench.py) and its own ledger
  _private/lint/         the static checks of the port's contracts

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back. This
module and the runtime's control plane (the GCS, the raylet, the fork
server) never import torch: a worker first touches CUDA after its lease's
``CUDA_VISIBLE_DEVICES`` is set; importing ``train``, ``tune``, ``data``,
``rllib``, ``dag``, ``experimental``, ``workflow``, ``dashboard``,
``job_submission``, ``autoscaler`` or ``scripts`` loads no torch either, so
a trainer's trial actor, an RL env runner, the head and the CLI never load
it.

Attribute access is lazy (PEP 562), as in ``ray_tpu``: control-plane
processes that import only their own submodules don't pay for the API.
"""

from ray_tpu_torch._version import version as __version__

_API = {
    "available_resources", "cancel", "cluster_resources", "get", "init",
    "is_initialized", "kill", "nodes", "put", "remote", "shutdown",
    "timeline", "wait",
}

__all__ = sorted(
    _API
    | {
        "__version__", "ObjectRef", "ActorClass", "ActorHandle", "get_actor",
        "RemoteFunction", "get_runtime_context", "exceptions", "method",
    }
)


def __getattr__(name):
    if name in _API:
        import ray_tpu_torch.api as _api

        return getattr(_api, name)
    if name == "ObjectRef":
        from ray_tpu_torch._private.object_ref import ObjectRef

        return ObjectRef
    if name in ("ActorClass", "ActorHandle", "get_actor"):
        import ray_tpu_torch.actor as _actor

        return getattr(_actor, name)
    if name == "RemoteFunction":
        from ray_tpu_torch.remote_function import RemoteFunction

        return RemoteFunction
    if name == "get_runtime_context":
        from ray_tpu_torch.runtime_context import get_runtime_context

        return get_runtime_context
    if name == "exceptions":
        import ray_tpu_torch.exceptions as _exc

        return _exc
    if name == "method":
        from ray_tpu_torch.actor import method

        return method
    if name == "util":
        import ray_tpu_torch.util as _util

        return _util
    if name == "cluster_utils":
        import ray_tpu_torch.cluster_utils as _cu

        return _cu
    if name in ("train", "tune", "serve", "data", "rllib", "workflow", "dag",
                "experimental", "autoscaler", "job_submission"):
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute '{name}'")
