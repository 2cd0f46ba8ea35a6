"""Worker process for the multi-host (jax.distributed) test.

Launched by tests/test_multihost.py as 2 processes x 4 CPU devices each:
a real cross-process mesh (the DCN analogue), not the single-process
virtual mesh the rest of the suite uses.  Drives make_sharded_track_fn
end-to-end over the global 8-device mesh and checks the local shard
against the single-chip oracle, then exercises the abort-flag collective
pattern (pmax over the mesh axis, ops/segmented.py:219-296 semantics)
across the process boundary.

Usage: python multihost_worker.py <process_id> <num_processes> <coord>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    proc_id, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=proc_id
    )
    assert len(jax.local_devices()) == 4, jax.local_devices()
    assert len(jax.devices()) == 4 * nproc, jax.devices()

    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, PartitionSpec as P

    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models.trifocal import (
        TrifocalProblem,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import tracker
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.parallel import (
        mesh as pmesh,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        EngineConfig,
    )

    cfg = EngineConfig()
    cfg = dataclasses.replace(
        # predictor_handoff off: the CPH condition is per-shard in the
        # distributed program but batch-wide in the single-chip oracle.
        cfg, hc=dataclasses.replace(cfg.hc, max_steps=3,
                                    predictor_handoff=False)
    )
    problem = TrifocalProblem.load(cfg)
    mesh = pmesh.make_mesh()  # all 8 global devices
    assert mesh.devices.size == 4 * nproc
    track = pmesh.make_sharded_track_fn(problem, cfg.hc, mesh)

    # Tiny deterministic workload, identical on every process: 8 hypotheses
    # x 312 tracks; each process contributes its hypothesis half as the
    # LOCAL shard of the global batch axis.
    H = 8
    T = problem.num_tracks
    rng = np.random.default_rng(0)
    x0 = np.tile(np.asarray(problem.start_sols), (H, 1))
    tgt = np.asarray(problem.start_params)[None] + 0.01 * (
        rng.standard_normal((H, problem.num_params + 1))
        + 1j * rng.standard_normal((H, problem.num_params + 1))
    )
    tgt[:, -1] = 1.0
    tgt_b = np.repeat(tgt, T, axis=0).astype(np.complex64)
    diff_b = (tgt_b - problem.start_params).astype(np.complex64)

    B = H * T
    lo, hi = proc_id * B // nproc, (proc_id + 1) * B // nproc
    f32 = np.float32

    def to_global(a):
        return multihost_utils.host_local_array_to_global_array(
            a[lo:hi].astype(f32), mesh, P("hyp")
        )

    planes = [
        to_global(a)
        for a in (x0.real, x0.imag, tgt_b.real, tgt_b.imag,
                  diff_b.real, diff_b.imag)
    ]
    out = track.jitted(*planes, np.full((8, 6), 1e3, f32),
                       np.eye(3, dtype=f32), f32(8))
    local = [
        multihost_utils.global_array_to_host_local_array(
            o, mesh, P("hyp")
        ) for o in out[:6]
    ]
    local = [np.asarray(a) for a in local]

    # Single-chip oracle on the full batch; this process's shard must match.
    # Flags/steps are exact; x is mid-trajectory at max_steps=3, where the
    # sharded and unsharded programs compile to different XLA fusions whose
    # f32 accumulation order differs (same band test_parallel.py:53 uses).
    ref = tracker.make_track_fn(problem, cfg.hc)(x0, tgt_b, diff_b)
    np.testing.assert_allclose(
        local[0], ref.x.real[lo:hi], rtol=2e-2, atol=1e-2
    )
    np.testing.assert_array_equal(local[2], ref.converged[lo:hi])
    np.testing.assert_array_equal(
        local[5].astype(np.int64), ref.num_steps[lo:hi]
    )

    # Cross-process abort-flag collective: only process 1's shard raises
    # the flag; pmax over the mesh axis must deliver it to process 0
    # (the segment-boundary exchange of ops/segmented.py:219-296).
    def flag_exchange(local_flag):
        return jax.lax.pmax(jnp.max(local_flag), "hyp")

    flags = multihost_utils.host_local_array_to_global_array(
        np.array([1.0 if proc_id == 1 else 0.0] * 4, f32)
        if nproc > 1 else np.ones(4, f32),
        mesh, P("hyp"),
    )
    got = jax.jit(
        jax.shard_map(flag_exchange, mesh=mesh, in_specs=P("hyp"),
                      out_specs=P(), check_vma=False)
    )(flags)
    assert float(np.asarray(got)) == 1.0, got

    print(f"MULTIHOST_OK process {proc_id}/{nproc} "
          f"conv={int(local[2].sum())} of {hi - lo}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
