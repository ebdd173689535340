#!/usr/bin/env bash
# End-to-end LEARNING check of the PyTorch port, on the card: SSL pretrain on
# structured synthetic data, extract the backbone, train a linear probe over
# it; the probe's held-out top-1 must beat chance (0.10) by a wide margin
# (bar 0.5, as tests/e2e/run_learning_check.sh holds the JAX package).
# Validates aug -> SSL loss -> optimizer -> EMA / queue -> extract -> probe as
# a learning system, through the port's CLIs alone.
#
#   tests/e2e/run_learning_check_torch.sh \
#       simclr|mocov2|byol|simsiam|mocobyol|swav|densecl|pixpro|fastmoco|mocov3|mae \
#       |clip|dino|dinov2|beit|cae|convmae|distill|vmoe|mocov3_moe|random|random_mocov3 \
#       |random_mae|random_clip|random_dino|random_dinov2|random_beit|random_cae \
#       |random_convmae|random_distill|random_mocov3_moe \
#       [output dir [-o Section.key=value ...]]
#
# Overrides after the output dir go to the pretrain and to the probe alike
# (e.g. -o Global.seed=1 for another seed, -o FP16.enable=False for f32).
#
# The extract step loads the backbone into the probe config's model first
# and fails if any backbone entry would keep its random init (MAE's extract
# writes the global-pool probe's `fc_norm` at a LayerNorm's init, where the
# JAX package's fresh probe starts it). MoCo v3 probes its ViT encoder (`base.encoder`, re-rooted under
# `encoder`); MAE's extract keeps the encoder's patch embedding, class
# token and blocks under `backbone` and injects the fixed sin-cos table the
# pretrain added as the probe ViT's `pos_embed`, as
# tests/e2e/run_learning_check.sh:175-212 does. DINO and DINOv2 probe the
# student's backbone (`student.backbone`, re-rooted under `encoder`). CLIP is
# held by held-out text->image retrieval, not a probe
# (tests/e2e/clip_retrieval_check_torch.py, R@1 over the 10 class captions,
# bar 0.5). BEiT and CAE first train their dVAE tokenizer with the port
# (tests/e2e/dvae_structured.yaml), which must spread 32 images over at least
# 16 of its 512 codes (the JAX check's collapse guard), and hand its entries
# under `tokenizer` to the pretrain as `Global.pretrained_model`, as
# tests/e2e/run_learning_check.sh:85-121 does; BEiT's probe takes the
# pretrain's `encoder`, CAE's its top-level `patch_embed`, `blocks` and
# `norm`, ConvMAE's its three stages under `backbone` with `fc_norm` at init.
# `distill` trains a tiny RegNetY teacher supervised
# (tests/e2e/regnet_teacher_structured.yaml; its held-out top-1 must pass the
# bar too), renames its checkpoint under `teacher` with the port's
# extract_weights and hands it to tests/e2e/distill_structured.yaml, which
# distills a tiny XCiT student from it; the student's held-out top-1 (the
# eval loop's) must pass the bar and beat the untrained student's
# (`random_distill`, the same eval over the fresh model); it also prints the
# student's top-1 agreement with the teacher on the held-out set.
# `vmoe` trains the tiny V-MoE classifier of tests/e2e/vmoe_structured.yaml
# (no extract, no probe): its held-out top-1 must pass 0.9 and its last logged
# router balance (E sum_e f_e P_e: 1 balanced, E collapsed) stay under 1.5, as
# tests/e2e/run_learning_check.sh:71-80 holds the JAX package. `mocov3_moe`
# pretrains MoCo v3 over a V-MoE encoder and probes it as `mocov3`; its last
# logged router balance must stay under 1.5 too (JAX `:125-130`).
# `random`, `random_mocov3`, `random_mae`, `random_dino`, `random_dinov2`,
# `random_beit`, `random_cae`, `random_convmae` and `random_mocov3_moe` are the
# floors: no pretraining, the same probe over the untrained ResNet-18 backbone,
# MoCo v3, MAE (its sin-cos table injected), DINO, DINOv2, BEiT, CAE, ConvViT or
# MoCo v3 V-MoE encoder; `random_clip` is the retrieval of the untrained CLIP. A method
# learned only by as much as its reading clears its floor.
# The floors print their reading and exit 0: they pass or fail no bar.
set -euo pipefail
cd "$(dirname "$0")/../.."
METHOD=${1:-simclr}
OUT=${2:-./output/learning_torch_$METHOD}
shift $(( $# < 2 ? $# : 2 ))
EXTRA=("$@")
PROBE_CFG=tests/e2e/probe_structured.yaml
RENAME=backbone
BAR=0.5
PRETRAIN_EXTRA=()
case "$METHOD" in
  simclr) CFG=tests/e2e/simclr_structured.yaml; PREFIX=backbone ;;
  mocov2) CFG=tests/e2e/mocov2_structured.yaml; PREFIX=encoder_q.backbone ;;
  byol)   CFG=tests/e2e/byol_structured.yaml;   PREFIX=online.backbone ;;
  simsiam) CFG=tests/e2e/simsiam_structured.yaml; PREFIX=encoder.backbone ;;
  mocobyol) CFG=tests/e2e/mocobyol_structured.yaml; PREFIX=online.backbone ;;
  swav)   CFG=tests/e2e/swav_structured.yaml;   PREFIX=backbone ;;
  densecl) CFG=tests/e2e/densecl_structured.yaml; PREFIX=encoder_q.backbone ;;
  pixpro) CFG=tests/e2e/pixpro_structured.yaml; PREFIX=encoder.backbone ;;
  fastmoco) CFG=tests/e2e/fastmoco_structured.yaml; PREFIX=online.backbone ;;
  mocov3) CFG=tests/e2e/mocov3_structured.yaml; PREFIX=base.encoder; RENAME=encoder
          PROBE_CFG=tests/e2e/probe_mocov3_structured.yaml
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.75 ;;
  mae)    CFG=tests/e2e/mae_structured.yaml; PREFIX=__mae__
          PROBE_CFG=tests/e2e/probe_mae_structured.yaml ;;
  clip)   CFG=tests/e2e/clip_structured.yaml; PREFIX=__clip__ ;;
  dino)   CFG=tests/e2e/dino_structured.yaml; PREFIX=student.backbone; RENAME=encoder
          PROBE_CFG=tests/e2e/probe_dino_structured.yaml
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.5 ;;
  dinov2) CFG=tests/e2e/dinov2_structured.yaml; PREFIX=student.backbone; RENAME=encoder
          PROBE_CFG=tests/e2e/probe_dinov2_structured.yaml
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.5 ;;
  beit)   CFG=tests/e2e/beit_structured.yaml; PREFIX=encoder; RENAME=encoder
          PROBE_CFG=tests/e2e/probe_beit_structured.yaml; TOKENIZER=1
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.75 ;;
  cae)    CFG=tests/e2e/cae_structured.yaml; PREFIX=patch_embed,blocks,norm; RENAME=
          PROBE_CFG=tests/e2e/probe_cae_structured.yaml; TOKENIZER=1 ;;
  convmae) CFG=tests/e2e/convmae_structured.yaml; PREFIX=__convmae__
          PROBE_CFG=tests/e2e/probe_convmae_structured.yaml
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.75 ;;
  distill) CFG=tests/e2e/distill_structured.yaml; PREFIX=__distill__ ;;
  vmoe)   CFG=tests/e2e/vmoe_structured.yaml; PREFIX=__supervised__ ;;
  mocov3_moe) CFG=tests/e2e/mocov3_moe_structured.yaml; PREFIX=base.encoder; RENAME=encoder
          PROBE_CFG=tests/e2e/probe_mocov3_moe_structured.yaml; BALANCE_BAR=1.5
          PRETRAIN_EXTRA=(-o Global.print_batch_step=1); LOSS_BAR=0.75 ;;
  random) CFG=; PREFIX= ;;
  random_mocov3) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_mocov3_structured.yaml ;;
  random_mae) CFG=tests/e2e/mae_structured.yaml; PREFIX=__mae__
          PROBE_CFG=tests/e2e/probe_mae_structured.yaml ;;
  random_clip) CFG=tests/e2e/clip_structured.yaml; PREFIX=__clip__ ;;
  random_dino) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_dino_structured.yaml ;;
  random_dinov2) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_dinov2_structured.yaml ;;
  random_beit) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_beit_structured.yaml ;;
  random_cae) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_cae_structured.yaml ;;
  random_convmae) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_convmae_structured.yaml ;;
  random_distill) CFG=tests/e2e/distill_structured.yaml; PREFIX=__distill__ ;;
  random_mocov3_moe) CFG=; PREFIX=; PROBE_CFG=tests/e2e/probe_mocov3_moe_structured.yaml ;;
  *) echo "unknown method $METHOD (simclr | mocov2 | byol | simsiam | mocobyol | swav |" \
       "densecl | pixpro | fastmoco | mocov3 | mae | clip | dino | dinov2 | beit | cae |" \
       "convmae | distill | vmoe | mocov3_moe | random | random_mocov3 | random_mae |" \
       "random_clip | random_dino | random_dinov2 | random_beit | random_cae | random_convmae |" \
       "random_distill | random_mocov3_moe)"; exit 2 ;;
esac
FLOOR=$([[ "$METHOD" == random* ]] && echo 1 || echo 0)
rm -rf "$OUT"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
start=$(date +%s)

hold_pretrain_loss() {
  [ -n "${LOSS_BAR:-}" ] || return 0
  # where the probe cannot tell the method from no training (random_mocov3
  # reads 0.998, random_dino 0.996, random_dinov2 1.000, random_convmae 0.969;
  # BEiT's probe reads below random_beit's), its own loss must fall, over the
  # last epoch to at most LOSS_BAR of the first step's (with the learning rate
  # at 0 MoCo v3's holds near its first step's, DINO's and DINOv2's rise as the
  # centers move)
  python - "$OUT/pretrain.log" "$LOSS_BAR" "$METHOD" <<'PYEOF'
import re
import sys

log, bar, method = open(sys.argv[1]).read(), float(sys.argv[2]), sys.argv[3]
rows = [(int(e), float(loss)) for e, loss in re.findall(
    r"\[Train\]\[Epoch (\d+)/\d+\]\[Iter: *\d+/\d+\] .*? loss: ([0-9.]+)", log)]
last = [r for r in rows if r[0] == rows[-1][0]]
loss = sum(r[1] for r in last) / len(last)
print(f"{method} pretrain loss: {rows[0][1]:.5f} at the first step, {loss:.5f} over epoch "
      f"{rows[-1][0]}; bar {bar} x the first: {bar * rows[0][1]:.5f}")
if not loss <= bar * rows[0][1]:
    raise SystemExit(f"{method}'s pretrain loss did not fall to the bar")
PYEOF
}

if [ -n "${TOKENIZER:-}" ]; then
  # the dVAE tokenizer the masked-token targets need, trained with the port; its
  # entries under `tokenizer` become the pretrain's Global.pretrained_model
  python -m passl_tpu_torch.tools.train -c tests/e2e/dvae_structured.yaml --device cuda \
    -o Global.output_dir="$OUT/dvae" "${EXTRA[@]}" | tee "$OUT/dvae.log"
  python -m passl_tpu_torch.tools.extract_weights --checkpoint "$OUT/dvae/latest.pt" \
    --prefix "" --rename tokenizer --output "$OUT/tokenizer.pt" --check-config "$CFG"
  python - "$OUT" <<'PYEOF'
import sys

import numpy as np
import torch

from passl_tpu_torch.data.datasets import StructuredSyntheticDataset
from passl_tpu_torch.models.discrete_vae import DiscreteVAE
from passl_tpu_torch.utils import io

# the collapse guard: a tokenizer that puts the synthetic set on a few codes
# makes the masked-token loss trivial and the check vacuous
out = sys.argv[1]
state = torch.load(io.resolve_checkpoint(f"{out}/dvae/latest.pt"), map_location="cpu",
                   weights_only=True)["model"]
tok = DiscreteVAE(vocab_size=512, hidden_dim=128, num_resblocks=1)
tok.load_state_dict(state)
ds = StructuredSyntheticDataset(size=32, image_size=32, num_classes=10, noise=0.2,
                                with_label=False)
imgs = np.stack([np.asarray(ds[i], np.float32) for i in range(32)]) / 255.0
with torch.no_grad():
    used = len(torch.unique(tok.tokenize(torch.from_numpy(imgs))))
print(f"dVAE codebook usage on 32 images: {used}/512 codes")
if used < 16:
    raise SystemExit(f"dVAE collapsed: only {used} codes in use")
PYEOF
  PRETRAIN_EXTRA+=(-o Global.pretrained_model="$OUT/tokenizer.pt")
fi

last_top1() { grep -oE "top1: [0-9.]+" "$1" | tail -1 | awk '{print $2}'; }
last_balance() { grep -oE "moe_balance: [0-9.]+" "$1" | tail -1 | awk '{print $2}'; }

hold_router_balance() {
  [ -n "${BALANCE_BAR:-}" ] || return 0
  # the router must not collapse onto few experts over the pretrain
  bal=$(last_balance "$OUT/pretrain.log")
  echo "router balance after the pretrain: $bal (1.0 = balanced, bar < $BALANCE_BAR)"
  awk -v t="$bal" -v b="$BALANCE_BAR" 'BEGIN { exit !(t < b) }'
}

if [ "$PREFIX" = __distill__ ]; then
  # the untrained student's held-out top-1: the eval loop over the fresh model
  # from the config's seed (the floor)
  python -m passl_tpu_torch.tools.eval -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/floor" "${EXTRA[@]}" | tee "$OUT/floor.log"
  floor=$(last_top1 "$OUT/floor.log")
  if [ "$FLOOR" = 1 ]; then
    end=$(date +%s)
    echo "FINAL random-init floor ($METHOD) student top1: $floor (chance = 0.10); wall time" \
      "$((end - start)) s"
    exit 0
  fi
  python -m passl_tpu_torch.tools.train -c tests/e2e/regnet_teacher_structured.yaml \
    --device cuda -o Global.output_dir="$OUT/teacher" "${EXTRA[@]}" | tee "$OUT/teacher.log"
  teacher=$(last_top1 "$OUT/teacher.log")
  echo "distill: the teacher's held-out top1: $teacher (bar = $BAR)"
  awk -v t="$teacher" -v b="$BAR" 'BEGIN { exit !(t > b) }'
  python -m passl_tpu_torch.tools.extract_weights --checkpoint "$OUT/teacher/latest.pt" \
    --prefix "" --rename teacher --output "$OUT/teacher.pt" --check-config "$CFG"
  python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/student" -o Global.pretrained_model="$OUT/teacher.pt" \
    "${EXTRA[@]}" | tee "$OUT/student.log"
  top1=$(last_top1 "$OUT/student.log")
  python - "$OUT" "$CFG" <<'PYEOF'
import sys

import numpy as np
import torch

from passl_tpu_torch.data import build_dataset
from passl_tpu_torch.models import build_model
from passl_tpu_torch.utils import cfg_util, io

# the student's top-1 agreement with its teacher on the held-out set
out, cfg_path = sys.argv[1:]
cfg = cfg_util.get_config(cfg_path, show=False)
model = build_model(dict(cfg["Model"]))
model.load_state_dict(torch.load(io.resolve_checkpoint(f"{out}/student/latest.pt"),
                                 map_location="cpu", weights_only=True)["model"])
model = model.cuda().eval()
ds = build_dataset(cfg["DataLoader"]["Eval"]["dataset"])
images = torch.from_numpy(np.stack([np.asarray(ds[i][0], np.float32) for i in range(len(ds))]))
with torch.no_grad():
    s = model.student(images.cuda()).argmax(-1)
    t = model.teacher(images.cuda()).argmax(-1)
print(f"distill: student-teacher top-1 agreement on the {len(ds)} held-out images: "
      f"{(s == t).float().mean().item():.4f}")
PYEOF
  end=$(date +%s)
  echo "FINAL $METHOD student top1: $top1 (teacher $teacher, untrained student $floor," \
    "chance = 0.10, bar = $BAR); wall time $((end - start)) s"
  awk -v t="$top1" -v b="$BAR" -v f="$floor" 'BEGIN { exit !(t > b && t > f) }'
  echo "LEARNING CHECK PASSED"
  exit 0
elif [ "$PREFIX" = __clip__ ]; then
  # CLIP: held-out text->image retrieval of the trained (or, for the floor,
  # the untrained) model, not a probe
  CKPT=none
  if [ "$FLOOR" = 0 ]; then
    python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
      -o Global.output_dir="$OUT/pretrain" "${EXTRA[@]}" | tee "$OUT/pretrain.log"
    CKPT="$OUT/pretrain/latest.pt"
  fi
  PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}" \
    python tests/e2e/clip_retrieval_check_torch.py "$CFG" "$CKPT" --device cuda \
    | tee "$OUT/retrieval.log" || true
  end=$(date +%s)
  r1=$(grep -oE "R@1: [0-9.]+" "$OUT/retrieval.log" | tail -1 | awk '{print $2}')
  [ -n "$r1" ] || { echo "no R@1 reading"; exit 1; }
  times="wall time $((end - start)) s"
  if [ "$FLOOR" = 1 ]; then
    echo "FINAL random-init floor ($METHOD) retrieval R@1: $r1 (chance = 0.10); $times"
    exit 0
  fi
  echo "FINAL $METHOD retrieval R@1: $r1 (chance = 0.10, bar = $BAR); $times"
  awk -v t="$r1" -v b="$BAR" 'BEGIN { exit !(t > b) }'
  echo "LEARNING CHECK PASSED"
  exit 0
elif [ "$PREFIX" = __supervised__ ]; then
  # the model is the classifier: the eval loop's held-out top-1 and the last
  # logged router balance
  python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/train" "${EXTRA[@]}" | tee "$OUT/train.log"
  top1=$(last_top1 "$OUT/train.log")
  bal=$(last_balance "$OUT/train.log")
  end=$(date +%s)
  echo "FINAL $METHOD supervised top1: $top1 (chance = 0.10, bar = 0.9), router balance:" \
    "$bal (bar < 1.5); wall time $((end - start)) s"
  awk -v t="$top1" -v b="$bal" 'BEGIN { exit !(t > 0.9 && b < 1.5) }'
  echo "LEARNING CHECK PASSED"
  exit 0
elif [ "$FLOOR" = 1 ] && [ -z "$CFG" ]; then  # the floor: the probe over the untrained backbone
  PRETRAINED=None
elif [ "$PREFIX" = __mae__ ]; then
  # MAE's encoder (of the trained model, or for the floor of the untrained
  # one, initialised from the pretrain config's seed as the trainer does),
  # the sin-cos table as pos_embed, fc_norm at init; every probe backbone entry filled
  if [ "$FLOOR" = 0 ]; then
    python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
      -o Global.output_dir="$OUT/pretrain" "${EXTRA[@]}" | tee "$OUT/pretrain.log"
  fi
  python - "$OUT" "$CFG" "$PROBE_CFG" "$FLOOR" <<'PYEOF'
import sys

import torch

from passl_tpu_torch.models import build_model
from passl_tpu_torch.nn.init import init_module
from passl_tpu_torch.tools import extract_weights
from passl_tpu_torch.utils import cfg_util, io

out, cfg_path, probe, floor = sys.argv[1:]
cfg = cfg_util.get_config(cfg_path, show=False)
if floor == "1":
    model = init_module(build_model(dict(cfg["Model"])),
                        torch.Generator().manual_seed(int(cfg["Global"]["seed"])))
    state = model.state_dict()
else:
    state = torch.load(io.resolve_checkpoint(f"{out}/pretrain/latest.pt"), map_location="cpu",
                       weights_only=True)["model"]
picked = extract_weights.mae_encoder(state, int(cfg["Model"]["img_size"]))
torch.save(picked, f"{out}/backbone.pt")
print(f"MAE extract: {len(picked)} tensors (sin-cos pos_embed injected, fc_norm at init)")
extract_weights.require_filled(probe, f"{out}/backbone.pt", "backbone")
PYEOF
  PRETRAINED="$OUT/backbone.pt"
elif [ "$PREFIX" = __convmae__ ]; then
  # ConvMAE's three stages under `backbone`, the global-pool probe's fc_norm at
  # init; every probe backbone entry filled
  python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/pretrain" "${EXTRA[@]}" "${PRETRAIN_EXTRA[@]}" \
    | tee "$OUT/pretrain.log"
  hold_pretrain_loss
  python - "$OUT" "$PROBE_CFG" <<'PYEOF'
import sys

import torch

from passl_tpu_torch.tools import extract_weights
from passl_tpu_torch.utils import io

out, probe = sys.argv[1:]
state = torch.load(io.resolve_checkpoint(f"{out}/pretrain/latest.pt"), map_location="cpu",
                   weights_only=True)["model"]
picked = extract_weights.convmae_encoder(state)
torch.save(picked, f"{out}/backbone.pt")
print(f"ConvMAE extract: {len(picked)} tensors (fc_norm at init)")
extract_weights.require_filled(probe, f"{out}/backbone.pt", "backbone")
PYEOF
  PRETRAINED="$OUT/backbone.pt"
else
  python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/pretrain" "${EXTRA[@]}" "${PRETRAIN_EXTRA[@]}" \
    | tee "$OUT/pretrain.log"
  hold_pretrain_loss
  hold_router_balance
  # CAE keeps its encoder at the top level under the probe's own names: no rename
  python -m passl_tpu_torch.tools.extract_weights \
    --checkpoint "$OUT/pretrain/latest.pt" --prefix "$PREFIX" \
    $([ -n "$RENAME" ] && echo "--rename $RENAME" || echo --no-strip-prefix) \
    --output "$OUT/backbone.pt" --check-config "$PROBE_CFG"
  PRETRAINED="$OUT/backbone.pt"
fi
pretrained=$(date +%s)

python -m passl_tpu_torch.tools.train -c "$PROBE_CFG" --device cuda \
  -o Global.output_dir="$OUT/probe" \
  -o Global.pretrained_model="$PRETRAINED" "${EXTRA[@]}" | tee "$OUT/probe.log"
end=$(date +%s)

top1=$(grep -oE "top1: [0-9.]+" "$OUT/probe.log" | tail -1 | awk '{print $2}')
times="wall time $((end - start)) s (pretrain and extract $((pretrained - start)) s, probe"
times="$times $((end - pretrained)) s)"
if [ "$FLOOR" = 1 ]; then  # a reading to measure margins by, held to no bar
  echo "FINAL random-init floor ($METHOD) linear-probe top1: $top1 (chance = 0.10); $times"
  exit 0
fi
echo "FINAL $METHOD linear-probe top1: $top1 (chance = 0.10, bar = $BAR); $times"
awk -v t="$top1" -v b="$BAR" 'BEGIN { exit !(t > b) }'
echo "LEARNING CHECK PASSED"
