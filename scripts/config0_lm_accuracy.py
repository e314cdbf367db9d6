"""eval.py's config 0 on the card with every fused LM evaluation checked
against its plain version and a float64 reference: whether `lm_evaluate`'s
sums are less exact than the CPU's, or the normal equations ill-conditioned.

    python scripts/config0_lm_accuracy.py record|plain DATASET_DIR OUT.json

For the first 400 evaluations of `ops.LMEvaluator` on the card it records the
relative error of the kernel's and of the plain version's H (against the
largest |H| entry) and b (against the largest |b|) with respect to the plain
version evaluated in float64 on the CPU, and the condition number of H. With
`plain` the run continues on the plain version's sums (computed on the card)
instead of the kernel's: the ATE the card gives when only the LM evaluation's
summation order changes. Needs a CUDA card.
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import config0_frames as c0  # noqa: E402
from uwslam_tpu_torch.ops import cuda_track as ct  # noqa: E402

MAX_RECORDS = 400


def main(mode: str, data: str, out: str) -> None:
    recs = []
    orig = ct.LMEvaluator.__call__

    def call(self, T):
        res = orig(self, T)
        if self.device.type != "cuda":
            return res
        p3d, *rest = self._plain_args
        plain = ct.lm_evaluate_plain(self.target, p3d, T, *rest)
        if len(recs) < MAX_RECORDS:
            args64 = [a.double().cpu() if isinstance(a, torch.Tensor) and a.is_floating_point()
                      else (a.cpu() if isinstance(a, torch.Tensor) else a)
                      for a in (self.target, p3d, T, *rest)]
            ref = ct.lm_evaluate_plain(*args64).double()
            k, p = res.double().cpu(), plain.double().cpu()
            sc = max(ref[:, :36].abs().amax().item(), 1e-30)
            recs.append({"n": len(recs), "valid": float(p[0, 44]),
                         "kernel_H_err": (k[:, :36] - ref[:, :36]).abs().max().item() / sc,
                         "plain_H_err": (p[:, :36] - ref[:, :36]).abs().max().item() / sc,
                         "kernel_b_err": (k[:, 36:42] - ref[:, 36:42]).abs().max().item(),
                         "plain_b_err": (p[:, 36:42] - ref[:, 36:42]).abs().max().item(),
                         "b_scale": ref[:, 36:42].abs().max().item(),
                         "cond": torch.linalg.cond(ref[0, :36].view(6, 6)).item()})
        return plain.contiguous() if mode == "plain" else res

    ct.LMEvaluator.__call__ = call
    r = c0.run(Path(data), "cuda", None)
    r.update(lm_records=recs, mode=mode)
    Path(out).write_text(json.dumps(r))
    print(json.dumps({"mode": mode, "ate": r["ate"], "records": len(recs)}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("config0_lm_accuracy: no CUDA card is visible")
    main(*sys.argv[1:4])
