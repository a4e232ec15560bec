"""RangeNet's logits on the keyframes the program labelled, against a
plain float32 darknet53 (perfbench/reference/rangenet.py) on the same
images, from weights rebuilt from the configuration's seed.

It captures the program's keyframe labelling on the net's own
projection, `lis_slam_torch.semantic.inference.infer_own_labels` (the
image and mask the net was fed, its float32 logits and its pixel labels),
on every sampled scan that is a keyframe and on the first four keyframes
of the session that are not, so that a session gives at least four.

Numbers, each the largest over the captured keyframes, over the pixels
that hold a point, on the scale of that image's largest |reference
logit|:

- `rangenet_logit_gap`: |program logit - reference logit|;
- `rangenet_label_margin`: the reference's best logit less its logit at
  the program's label, 0 where the program chose the reference's best.

The control puts in the program's place the reference with each
convolution's input and kernel rounded to float8_e4m3fn (one scale a
tensor), the precision below the program's bf16.

Set-up imports this module to sort a cell's limits, so it imports
neither numpy nor torch at its top.
"""

from __future__ import annotations

import math

NUMBERS = ("rangenet_logit_gap", "rangenet_label_margin")
CAPTURES = (("lis_slam_torch.semantic.inference", "infer_own_labels"),)
UNSAMPLED = 4  # keyframes kept a session besides the sampled ones

_session = {"last": -1, "unsampled": 0}


def keep(scan_index, sample, args, kwargs, result):
    if scan_index <= _session["last"]:  # a new session
        _session["unsampled"] = 0
    _session["last"] = scan_index
    if scan_index not in sample:
        if _session["unsampled"] >= UNSAMPLED:
            return None
        _session["unsampled"] += 1
    sem = (args[2] if len(args) > 2 else kwargs["cfg"]).semantic
    return {"scan": scan_index,
            "image": result.image.detach().clone(),
            "mask": result.mask.detach().clone(),
            "logits": result.logits.detach().clone(),
            "labels": result.labels.detach().clone(),
            "arch": arch_of(sem)}


def arch_of(sem) -> dict:
    """The architecture a SemanticConfig states, as the reference's counts
    take it."""
    return {"blocks": tuple(sem.enc_blocks), "widths": tuple(sem.enc_widths),
            "dec_widths": tuple(sem.dec_widths), "classes": sem.num_classes,
            "in_channels": sem.model_input_c}


def numbers(logits, labels, ref, mask) -> dict:
    """The two numbers of one keyframe: `logits` (H, W, K) and `labels`
    (H, W) in the program's place, `ref` the reference's logits."""
    import torch

    scale = ref[mask].abs().max()
    gap = (logits.float() - ref).abs().amax(dim=-1)
    best = ref.amax(dim=-1)
    at = torch.gather(ref, -1, labels.long()[..., None])[..., 0]
    return {"rangenet_logit_gap": float(gap[mask].max() / scale),
            "rangenet_label_margin": float((best - at)[mask].max() / scale)}


def _reference(captured, cfg: dict, device, rounding=None):
    """(the reference's logits, item) for each captured keyframe, from
    the tree `rangenet_seeded` draws from the configuration's weight seed
    (the tree every darknet53 weights file of the benchmark loads)."""
    import torch

    from perfbench.harness import program
    from perfbench.reference import rangenet as R
    from perfbench.weights import rangenet_seeded

    pcfg = program.build_config(cfg)
    tree = rangenet_seeded.build(pcfg, int(cfg["weights"]["seed"]), device)
    w = R.tensors(tree, device)
    del tree
    for item in captured:
        x = item["image"].to(device)[None]
        yield R.forward(w, x, item["arch"]["blocks"], rounding)[0], item
    del w
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _worst(rows) -> dict:
    out = dict.fromkeys(NUMBERS, -math.inf)
    for row in rows:
        for k, v in row.items():
            out[k] = max(out[k], v)
    return out


def readings(captured, cfg, traffic, device) -> dict:
    if not captured:
        return dict.fromkeys(NUMBERS, math.inf)
    return _worst(numbers(item["logits"].to(ref.device),
                          item["labels"].to(ref.device), ref,
                          item["mask"].to(ref.device))
                  for ref, item in _reference(captured, cfg, device))


def control(captured, cfg, traffic, device) -> dict:
    import torch

    from perfbench.reference import rangenet as R

    if not captured:
        return dict.fromkeys(NUMBERS, math.inf)
    fp32 = list(_reference(captured, cfg, device))
    fp8 = list(_reference(captured, cfg, device, R.round_fp8))
    rows = []
    for (ref, item), (low, _item) in zip(fp32, fp8):
        mask = item["mask"].to(ref.device)
        lab = torch.where(mask, low.argmax(dim=-1), 0)
        rows.append(numbers(low, lab, ref, mask))
    return _worst(rows)
