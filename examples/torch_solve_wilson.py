"""End-to-end driver example of the PyTorch/CUDA port: Wilson solves
with checkpointing and a restart, then a backend sweep.  The backend is
a registry string (``repro_torch.backends``), and every solve iterates
in the chosen backend's native vector domain (complex for
``torch_ref``, planar for the CUDA kernels, a rank's planar block for
``distributed``) with encode/decode only at solve entry and exit.

Each ``solve.main`` run binds the gauge once into a ``WilsonMatrix`` and
pushes every solve through one ``SolveSession``, so the session report
at the end of each block shows one pipeline build for many solves.

  PYTHONPATH=src python examples/torch_solve_wilson.py          # the GPU
  PYTHONPATH=src python examples/torch_solve_wilson.py --device cpu \\
      --lattice wilson-8x8x8x8
"""
import argparse
import tempfile

from repro_torch.launch import solve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--lattice", default="wilson-16x16x16x16",
                    help="a config name of repro_torch.configs")
    args = ap.parse_args(argv)
    common = ["--lattice", args.lattice, "--device", args.device,
              "--n-solves", "1"]

    with tempfile.TemporaryDirectory() as d:
        print("=== two solves with checkpointing ===")
        solve.main(common[:4] + ["--tol", "1e-5", "--n-solves", "2",
                                 "--ckpt-dir", d])
        print("\n=== restart: resume the same workload (idempotent) ===")
        solve.main(common + ["--tol", "1e-5", "--ckpt-dir", d])
    print("\n=== same solve through the fused-kernel backend ===")
    solve.main(common + ["--tol", "1e-5", "--backend", "cuda_fused"])
    print("\n=== lattice split between ranks (one rank here; torchrun "
          "for more): the iterate stays a rank's block ===")
    solve.main(common + ["--tol", "1e-5", "--backend", "distributed",
                         "--recompute-every", "25"])
    print("\n=== multi-RHS: 4 sources in ONE batched Krylov solve (gauge "
          "streamed once per application for the whole block) ===")
    solve.main(common + ["--tol", "1e-5", "--nrhs", "4", "--method",
                         "bicgstab"])
    print("\n=== mixed precision: f32 inner solves, f64 outer "
          "iterative-refinement loop to 1e-10 ===")
    solve.main(common + ["--tol", "1e-10", "--inner-dtype", "f32"])
    print("\n=== plain CG on the normal equations (--method cg, the "
          "choice list is derived from SolveSpec.METHODS) ===")
    solve.main(common + ["--tol", "1e-5", "--method", "cg"])


if __name__ == "__main__":
    main()
