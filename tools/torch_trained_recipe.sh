#!/bin/bash
# The trained-model recipe on one CUDA card, from the repository root:
#   bash tools/torch_trained_recipe.sh [OUT]      (OUT: build/trained)
# It needs nothing from earlier runs: the data and the model are made here.
# Data (tools/data/make_synthetic.py --hard, 4096 images); a one-epoch arm
# with the images decoded in the training process (its ms/step beside the
# main run's, which decodes in spawn workers); both arms for 15 epochs with
# the decode A/B and the saved model (build/abrun/model, about 2.2 GB);
# tools/torch_bench_trained.py in bf16 and int8, with early stopping, with
# --no_early_stopping and with every step (--min_length 64); the evaluate
# CLI's BLEU in bf16 and int8.  Logs and report.json go to OUT.
set -eo pipefail
OUT=${1:-build/trained}
mkdir -p $OUT
ms() { echo $(( ($(date +%s%N) - $1) / 1000000 )); }
CALL0=$(date +%s%N)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $OUT/card.txt
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
T0=$(date +%s%N)
python3 tools/data/make_synthetic.py --out build/hard --n 4096 --hard
echo "data made in $(ms $T0) ms"
T0=$(date +%s%N)
python3 tools/torch_ab_hard_synthetic.py --data build/hard --out build/t0 --epochs 1 \
  --num_workers 0 --skip_shadow_off --skip_decode_ab 2>&1 | tee $OUT/epoch_workers0.txt | grep -v '^{'
echo "one epoch at 0 workers: wall $(ms $T0) ms"
rm -rf build/t0
T0=$(date +%s%N)
python3 tools/torch_ab_hard_synthetic.py --data build/hard --out build/abrun --save_model \
  2>&1 | tee $OUT/ab.txt | grep -v '^{'
echo "the recipe (both arms, decode A/B, save): wall $(ms $T0) ms"
cp build/abrun/report.json $OUT/report.json
for q in bf16 int8; do
  for mode in early no_early full; do
    flags=""
    [ $q = int8 ] && flags="--quant int8"
    [ $mode = no_early ] && flags="$flags --no_early_stopping"
    [ $mode = full ] && flags="$flags --min_length 64"
    T0=$(date +%s%N)
    echo "== bench $q $mode ($flags)"
    if [ $q = int8 ]; then
      MIC_TPU_KV_QUANT=int8 python3 tools/torch_bench_trained.py --model build/abrun/model \
        --data build/hard $flags 2>&1 | tee $OUT/bench_${q}_${mode}.txt | grep -v '^{'
    else
      python3 tools/torch_bench_trained.py --model build/abrun/model --data build/hard $flags \
        2>&1 | tee $OUT/bench_${q}_${mode}.txt | grep -v '^{'
    fi
    echo "bench $q $mode wall $(ms $T0) ms"
  done
done
for q in bf16 int8; do
  T0=$(date +%s%N)
  echo "== evaluate $q"
  if [ $q = int8 ]; then
    MIC_TPU_DECODE_QUANT=int8 MIC_TPU_KV_QUANT=int8 python3 -m mic_tpu_torch.cli.evaluate \
      --model_dir build/abrun/model --tsv_path build/hard/val.tsv --images_dir build/hard/images \
      --max_length 24 --decode_size 32 --output_json $OUT/bleu_$q.json
  else
    python3 -m mic_tpu_torch.cli.evaluate \
      --model_dir build/abrun/model --tsv_path build/hard/val.tsv --images_dir build/hard/images \
      --max_length 24 --decode_size 32 --output_json $OUT/bleu_$q.json
  fi
  echo "evaluate $q wall $(ms $T0) ms"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
echo "call wall $(ms $CALL0) ms"
