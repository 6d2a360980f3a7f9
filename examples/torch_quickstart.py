"""Quickstart of the PyTorch/CUDA port: the paper's operator in five
steps.

  PYTHONPATH=src python examples/torch_quickstart.py            # the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Build a random SU(3) gauge field and a spinor source.
2. Apply the full-lattice Wilson matrix D_W.
3. Pack to the even-odd layout (the paper's data layout) and apply the
   hopping blocks: exactly the full operator.
4. Run the one-launch Dhat CUDA kernel (B2) and check it against its
   plain PyTorch version (on CPU tensors the wrapper runs that plain
   version itself).
5. Bind the operator ONCE into the public API's WilsonMatrix, solve
   D_W xi = eta through a SolveSession, and verify; a second solve
   reuses the built pipeline (see the session stats).
"""
import argparse

import torch

from repro_torch import api, resolve_device
from repro_torch.core import evenodd, su3, wilson
from repro_torch.kernels import layout, ops, ref


def _source(gen, shape, device):
    return torch.complex(torch.randn(shape + (4, 3), generator=gen),
                         torch.randn(shape + (4, 3), generator=gen)
                         ).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--lattice", default="8x8x8x8", help="TxZxYxX")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    shape = tuple(int(n) for n in args.lattice.split("x"))
    kappa = 0.13
    gen = torch.Generator().manual_seed(0)

    print("1) gauge + source ...")
    U = su3.random_gauge(gen, shape, device=device)
    eta = _source(gen, shape, device)
    print(f"   plaquette = {float(su3.plaquette(U)):.4f} "
          f"(unit gauge would be 1.0)")

    print("2) full-lattice D_W ...")
    d_eta = wilson.apply_wilson(U, eta, kappa)

    print("3) even-odd layout ...")
    Ue, Uo = evenodd.pack_gauge(U)
    ee, eo = evenodd.pack(eta)
    de = ee - kappa * evenodd.hop_eo(Ue, Uo, eo)
    do = eo - kappa * evenodd.hop_oe(Ue, Uo, ee)
    fe, fo = evenodd.pack(d_eta)
    err = max(float((de - fe).abs().max()), float((do - fo).abs().max()))
    print(f"   even-odd vs full operator: max err {err:.2e}")

    print(f"4) the one-launch Dhat kernel (B2) on {device} ...")
    Uep, Uop = layout.gauge_to_planar(Ue), layout.gauge_to_planar(Uo)
    ep = layout.spinor_to_planar(ee)
    got = ops.apply_dhat_planar_fused(Uep, Uop, ep, kappa)
    want = ref.dhat_planar_ref(Uep, Uop, ep, kappa)
    print(f"   kernel vs plain version: max err "
          f"{float((got - want).abs().max()):.2e}")

    print("5) solve D_W xi = eta (public API: WilsonMatrix + "
          "SolveSession, BiCGStab) ...")
    D = api.WilsonMatrix.bind(Ue, Uo, kappa)
    session = api.SolveSession(D, api.SolveSpec(method="bicgstab",
                                                tol=1e-6))
    xe, xo, res = session.solve(ee, eo)
    xi = evenodd.unpack(xe, xo)
    rel = float(torch.linalg.vector_norm(
        eta - wilson.apply_wilson(U, xi, kappa))
        / torch.linalg.vector_norm(eta))
    print(f"   backend {D.backend.name}: {int(res.iterations)} iterations, "
          f"true relative residual {rel:.2e}")

    print("   ... and a second same-shape solve reuses the built "
          "pipeline:")
    session.solve(*evenodd.pack(_source(gen, shape, device)))
    st = session.stats()
    print(f"   session stats: solves={st['solves']} "
          f"traces={st['traces']} cache_hits={st['cache_hits']}")
    print("done.")


if __name__ == "__main__":
    main()
