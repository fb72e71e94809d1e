"""Multi-host scaffolding: process init + (dcn, data, model) hybrid mesh.

The reference has no distributed layer (SURVEY.md §2.5; roadmap item
/root/reference/TODO.md:50). The multi-host story is:

  - one JAX process per host, joined with ``jax.distributed.initialize``
    (:func:`initialize` wraps it with env autodetection and makes repeat
    calls safe);
  - a hybrid mesh whose leading 'dcn' axis maps to the slow inter-host
    network and whose 'data'/'model' axes stay inside a host's fast
    device interconnect (NVLink within a GPU host) (:func:`make_host_mesh` uses
    ``mesh_utils.create_hybrid_device_mesh`` on real multi-process
    topologies and a plain reshape on single-process/virtual ones, so the
    same code path is testable on the 8-virtual-CPU mesh as 2 hosts x 4
    chips);
  - shardings that only ever put *batch* traffic on 'dcn'
    (:func:`host_llama_param_specs` replicates weights across hosts and
    tensor-parallelizes them inside a host; :func:`host_cache_specs`
    shards the KV cache batch over ('dcn','data') and heads over
    'model'), so every heavy collective (TP psum/all-gather) stays in a
    host
    and the only DCN traffic is data-parallel gradient psum (training)
    or nothing at all (serving — each host's continuous-batching engine
    feeds its own batch rows).

Serving across hosts = data parallelism over 'dcn': each host runs its
own Engine replica on its process-local batch slice; throughput scales
with hosts because no per-token collective crosses DCN. Four GPUs per
host with tp=4 is this layout.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quanta_tpu.models.llama import LlamaConfig
from quanta_tpu.parallel import sharding as _sh

# Batch ("data-parallel") axes: the DCN axis first so host boundaries
# split the batch at its outermost stride.
DP_AXES = ("dcn", "data")

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> int:
    """Join (or skip joining) the multi-host JAX runtime. Returns the
    process count.

    With no arguments: if the standard cluster env vars are set
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    cluster manager ``jax.distributed.initialize()`` can autodetect),
    join; otherwise stay single-process. Safe to call more
    than once (later calls are no-ops), so library entry points can call
    it unconditionally.
    """
    global _initialized
    if _initialized:
        return jax.process_count()

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        _initialized = True  # single-process: nothing to join
        return jax.process_count()

    # NOTE: nothing above may touch the backend (jax.process_count(),
    # jax.devices(), ...) — jax.distributed.initialize must run before
    # backend creation, and an early guard that called process_count()
    # would silently break every real multi-process launch (exercised by
    # tests/test_multiprocess.py, which joins two actual processes).
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:  # already joined by the launcher
        if "already" not in str(e).lower():
            raise
    _initialized = True
    return jax.process_count()


def make_host_mesh(
    data: int = 1,
    model: int = 1,
    dcn: Optional[int] = None,
    devices=None,
) -> Mesh:
    """Build a ('dcn', 'data', 'model') mesh.

    dcn defaults to ``jax.process_count()`` (1 without :func:`initialize`).
    data*model is the per-host ICI extent. On a real multi-process
    topology the device grid comes from
    ``mesh_utils.create_hybrid_device_mesh`` so the 'dcn' axis truly maps
    to host boundaries; single-process (tests, the virtual CPU mesh) uses
    a plain reshape, which makes an N-device host look like dcn
    simulated hosts of N/dcn chips — same program, same collectives.
    """
    devices = devices if devices is not None else jax.devices()
    dcn = dcn or max(jax.process_count(), 1)
    n = dcn * data * model
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")

    if jax.process_count() > 1:
        from jax.experimental import mesh_utils

        try:
            grid = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=(1, data, model),
                dcn_mesh_shape=(dcn, 1, 1),
                devices=devices,
            )
        except ValueError:
            # mesh_utils granules by slice_index, which CPU (and some
            # non-pod) topologies don't populate: granule by process
            # instead — the 'dcn' axis still lands exactly on process
            # boundaries (asserted in tests/test_multiprocess.py)
            by_proc: dict = {}
            for d in devices:
                by_proc.setdefault(d.process_index, []).append(d)
            if len(by_proc) != dcn:
                raise ValueError(
                    f"dcn={dcn} but {len(by_proc)} processes own devices"
                )
            rows = [
                sorted(by_proc[p], key=lambda d: d.id)[: data * model]
                for p in sorted(by_proc)
            ]
            grid = np.asarray(rows).reshape(dcn, data, model)
    else:
        grid = np.asarray(devices[:n]).reshape(dcn, data, model)
    return Mesh(grid, axis_names=("dcn", "data", "model"))


def _retag(spec: P) -> P:
    """Map a ('data','model') spec onto the host mesh: 'model' stays (TP
    inside a host over ICI); 'data' becomes the combined batch axes."""
    out = []
    for part in spec:
        if part == "data":
            out.append(DP_AXES)
        else:
            out.append(part)
    return P(*out)


def host_llama_param_specs(
    cfg: LlamaConfig, params: Optional[dict] = None
) -> dict:
    """Weights: TP on 'model' inside a host, replicated across 'dcn'."""
    return jax.tree_util.tree_map(
        _retag, _sh.llama_param_specs(cfg, params),
        is_leaf=lambda x: isinstance(x, P),
    )


def host_fsdp_param_specs(
    cfg: LlamaConfig, params: Optional[dict] = None, tp: bool = True
) -> dict:
    """FSDP weight shards stay inside a host ('data' on ICI); 'dcn' only
    carries the data-parallel gradient psum.

    No retag here ON PURPOSE: the inner specs' 'data' axis IS the ZeRO-3
    weight-shard axis, and mapping it to ('dcn','data') would make every
    per-layer weight all-gather cross DCN (the r3 advisor catch). The
    host mesh shares the 'data'/'model' axis names, so the inner specs
    apply directly: weights sharded inside a host, replicated over 'dcn';
    only the batch (host_batch_spec) and the gradient psum touch DCN."""
    return _sh.fsdp_param_specs(cfg, params, tp=tp)


def host_cache_specs(cfg: LlamaConfig) -> dict:
    """KV cache: batch over ('dcn','data'), heads over 'model'."""
    kv = P(None, DP_AXES, None, "model", None)
    return {"k": kv, "v": kv, "pos": P(DP_AXES)}


def host_batch_spec() -> P:
    """(B, S) token batches shard over ('dcn','data')."""
    return P(DP_AXES, None)


def shard_params_host(params, mesh: Mesh, cfg: Optional[LlamaConfig] = None,
                      specs=None):
    """device_put a param tree for the host mesh (weights dcn-replicated)."""
    if specs is None:
        specs = host_llama_param_specs(cfg, params)
    expanded = _sh.expand_specs(params, specs)
    return jax.tree_util.tree_map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        params,
        expanded,
    )


def process_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """The rows of a global batch owned by this process (engine feeding:
    each host's serving engine submits requests for its own slice)."""
    n_proc = max(jax.process_count(), 1)
    per = global_batch // n_proc
    pid = jax.process_index()
    return slice(pid * per, (pid + 1) * per)
