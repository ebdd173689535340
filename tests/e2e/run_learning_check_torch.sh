#!/usr/bin/env bash
# End-to-end LEARNING check of the PyTorch port, on the card: SSL pretrain on
# structured synthetic data, extract the backbone, train a linear probe over
# it; the probe's held-out top-1 must beat chance (0.10) by a wide margin
# (bar 0.5, as tests/e2e/run_learning_check.sh holds the JAX package).
# Validates aug -> SSL loss -> optimizer -> EMA / queue -> extract -> probe as
# a learning system, through the port's CLIs alone.
#
#   tests/e2e/run_learning_check_torch.sh simclr|mocov2|byol [output dir]
#
# The extract step loads the backbone into the probe config's model first
# and fails if any backbone entry would keep its random init.
set -euo pipefail
cd "$(dirname "$0")/../.."
METHOD=${1:-simclr}
OUT=${2:-./output/learning_torch_$METHOD}
PROBE_CFG=tests/e2e/probe_structured.yaml
BAR=0.5
case "$METHOD" in
  simclr) CFG=tests/e2e/simclr_structured.yaml; PREFIX=backbone ;;
  mocov2) CFG=tests/e2e/mocov2_structured.yaml; PREFIX=encoder_q.backbone ;;
  byol)   CFG=tests/e2e/byol_structured.yaml;   PREFIX=online.backbone ;;
  *) echo "unknown method $METHOD (simclr | mocov2 | byol)"; exit 2 ;;
esac
rm -rf "$OUT"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
start=$(date +%s)

python -m passl_tpu_torch.tools.train -c "$CFG" --device cuda \
  -o Global.output_dir="$OUT/pretrain" | tee "$OUT/pretrain.log"
pretrained=$(date +%s)

python -m passl_tpu_torch.tools.extract_weights \
  --checkpoint "$OUT/pretrain/latest.pt" \
  --prefix "$PREFIX" --rename backbone \
  --output "$OUT/backbone.pt" --check-config "$PROBE_CFG"

python -m passl_tpu_torch.tools.train -c "$PROBE_CFG" --device cuda \
  -o Global.output_dir="$OUT/probe" \
  -o Global.pretrained_model="$OUT/backbone.pt" | tee "$OUT/probe.log"
end=$(date +%s)

top1=$(grep -oE "top1: [0-9.]+" "$OUT/probe.log" | tail -1 | awk '{print $2}')
echo "FINAL $METHOD linear-probe top1: $top1 (chance = 0.10, bar = $BAR); wall time" \
  "$((end - start)) s (pretrain $((pretrained - start)) s, extract and probe" \
  "$((end - pretrained)) s)"
awk -v t="$top1" -v b="$BAR" 'BEGIN { exit !(t > b) }'
echo "LEARNING CHECK PASSED"
