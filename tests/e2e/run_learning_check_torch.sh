#!/usr/bin/env bash
# End-to-end LEARNING check of the PyTorch port, on the card: SSL pretrain on
# structured synthetic data, extract the backbone, train a linear probe over
# it; the probe's held-out top-1 must beat chance (0.10) by a wide margin
# (bar 0.5, as tests/e2e/run_learning_check.sh holds the JAX package).
# Validates aug -> SSL loss -> optimizer -> EMA / queue -> extract -> probe as
# a learning system, through the port's CLIs alone.
#
#   tests/e2e/run_learning_check_torch.sh \
#       simclr|mocov2|byol|simsiam|mocobyol|swav|densecl|pixpro|fastmoco|random \
#       [output dir [-o Section.key=value ...]]
#
# Overrides after the output dir go to the pretrain and to the probe alike
# (e.g. -o Global.seed=1 for another seed, -o FP16.enable=False for f32).
#
# The extract step loads the backbone into the probe config's model first
# and fails if any backbone entry would keep its random init. `random` is
# the floor: no pretraining, the probe over the untrained backbone (the JAX
# package's reads 0.529, above the bar); a method learned only by as much
# as its probe clears this floor. It prints its reading and exits 0: it
# passes or fails no bar.
set -euo pipefail
cd "$(dirname "$0")/../.."
METHOD=${1:-simclr}
OUT=${2:-./output/learning_torch_$METHOD}
shift $(( $# < 2 ? $# : 2 ))
EXTRA=("$@")
PROBE_CFG=tests/e2e/probe_structured.yaml
BAR=0.5
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
  random) CFG=; PREFIX= ;;
  *) echo "unknown method $METHOD (simclr | mocov2 | byol | simsiam | mocobyol | swav |" \
       "densecl | pixpro | fastmoco | random)"; exit 2 ;;
esac
rm -rf "$OUT"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
start=$(date +%s)

if [ "$METHOD" = random ]; then  # the floor: the probe over the untrained backbone
  PRETRAINED=None
else
  python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
    -o Global.output_dir="$OUT/pretrain" "${EXTRA[@]}" | tee "$OUT/pretrain.log"
  python -m passl_tpu_torch.tools.extract_weights \
    --checkpoint "$OUT/pretrain/latest.pt" \
    --prefix "$PREFIX" --rename backbone \
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
if [ "$METHOD" = random ]; then  # a reading to measure margins by, held to no bar
  echo "FINAL random-init floor linear-probe top1: $top1 (chance = 0.10); $times"
  exit 0
fi
echo "FINAL $METHOD linear-probe top1: $top1 (chance = 0.10, bar = $BAR); $times"
awk -v t="$top1" -v b="$BAR" 'BEGIN { exit !(t > b) }'
echo "LEARNING CHECK PASSED"
