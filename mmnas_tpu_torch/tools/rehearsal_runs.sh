#!/usr/bin/env bash
# The accuracy rehearsal of the PyTorch port on a CUDA GPU: makes the
# planted-signal corpora (tools/make_rehearsal_data.py, the stub GloVe
# caches) and runs, through mmnas_tpu_torch/tools/rehearsal.py, the commands
# whose JAX results docs/evidence/rehearsal_*.json hold; each run writes its
# docs/evidence/rehearsal_torch_*.json.
#
#   bash mmnas_tpu_torch/tools/rehearsal_runs.sh [small] [scaled] [leftovers] [xmodal] [rsa] [traces]
#
# from the repo root (default: every stage, in that order). small: the
# small tier's seven runs; scaled: vqa, vgd, itm on the scaled tier;
# leftovers: vgd for 16 epochs (both lr decays), itm with --itm_noise_q 0.3
# and with --itm_mine_skiptop 1; xmodal: the cross-modal discrimination
# contract (tools/xmodal_contract.py); rsa: arch/mmnas_vqa.json trained on
# the scaled tier, then tools/rsa_conditioning.py on its checkpoint and
# the corpus; traces: the second seed (45) of the runs that missed the JAX
# results, the searched ITM genotypes of the JAX package's and the port's
# small-tier searches (taken from their evidence files) trained by the port,
# and mcan on the xmodal corpus for 20 and 40 epochs through the per-item
# loader. A failed run is reported and the rest go on; the exit status
# is 1 if any failed. PYTHON names the interpreter (default python3).
set -u
PY=${PYTHON:-python3}
R="$PY -m mmnas_tpu_torch.tools.rehearsal"
ITM="--itm_lr 0.00003 --itm_decay_at 15 --itm_decay_r 5 --itm_mine_from 25"
SCALED=./data_rehearsal_scaled
failed=0

run() {
  echo "=== $* ($(date -u +%H:%M:%S))"
  "$@" || { echo "=== FAILED ($?): $*"; failed=1; }
}

corpus() {  # corpus <dir> [make_rehearsal_data.py flags]
  local dir=$1
  shift
  [ -f "$dir/rehearsal_meta.json" ] && return
  run $PY tools/make_rehearsal_data.py --out "$dir" "$@"
  for task in vqa vgd itm; do
    run $PY -m mmnas_tpu_torch.tools.make_glove_cache --task $task --data_root "$dir" --stub
  done
}

small() {
  corpus ./data_rehearsal
  run $R --task vqa --epochs 20
  run $R --task vgd --epochs 20
  run $R --task itm --epochs 40 $ITM
  run $R --task search_vqa --epochs 13
  run $R --task search_vqa --epochs 13 --search_kpath 8
  run $R --task search_vgd --epochs 13
  run $R --task search_itm --epochs 40 $ITM
}

scaled() {
  corpus $SCALED --tier scaled
  run $R --data_root $SCALED --task vqa --epochs 8
  run $R --data_root $SCALED --task vgd --epochs 8
  run $R --data_root $SCALED --task itm --epochs 30 $ITM
}

leftovers() {
  corpus $SCALED --tier scaled
  run $R --data_root $SCALED --task vgd --epochs 16 --evidence_tag ep16
  run $R --data_root $SCALED --task itm --epochs 30 $ITM --itm_noise_q 0.3
  run $R --data_root $SCALED --task itm --epochs 30 $ITM --itm_mine_skiptop 1
}

xmodal() {
  run $PY -m mmnas_tpu_torch.tools.xmodal_contract
}

rsa() {
  corpus $SCALED --tier scaled
  run $R --data_root $SCALED --task vqa --epochs 8 --arch_path ./arch/mmnas_vqa.json
  run $PY -m mmnas_tpu_torch.tools.rsa_conditioning --data_root $SCALED \
    --ckpt ./logs/ckpts/rehearsal_vqa_mmnas_vqa_epoch8.pkl --B 64 256
}

traces() {
  corpus ./data_rehearsal
  corpus $SCALED --tier scaled
  run $R --task search_itm --epochs 40 $ITM --seed 45
  run $R --data_root $SCALED --task itm --epochs 30 $ITM --seed 45
  run $R --data_root $SCALED --task itm --epochs 30 $ITM --itm_noise_q 0.3 --seed 45
  mkdir -p tmp
  for pair in jax:rehearsal_search_itm port:rehearsal_torch_search_itm; do
    run $PY -c "import json, sys
json.dump({'epoch0': json.load(open(sys.argv[1]))['searched_genotype']}, open(sys.argv[2], 'w'))" \
      docs/evidence/${pair#*:}.json tmp/${pair%%:*}_search_itm_arch.json
  done
  run $R --task itm --epochs 40 $ITM --arch_path tmp/jax_search_itm_arch.json
  run $R --task itm --epochs 40 $ITM --arch_path tmp/jax_search_itm_arch.json --seed 45
  run $R --task itm --epochs 40 $ITM --arch_path tmp/port_search_itm_arch.json --seed 45
  [ -f ./data_rehearsal_xmodal/rehearsal_meta.json ] || run $PY -c "
from mmnas_tpu_torch.tools.xmodal_contract import DATA_ROOT, make_corpus
make_corpus(DATA_ROOT)"
  run $R --data_root ./data_rehearsal_xmodal --task vqa --epochs 20
  run $R --data_root ./data_rehearsal_xmodal --task vqa --epochs 40 --evidence_tag ep40
}

stages=${*:-small scaled leftovers xmodal rsa traces}
# the kernels first (one nvcc a source, together), so no run's time holds a build
run $PY -c "from concurrent.futures import ThreadPoolExecutor
from mmnas_tpu_torch.csrc import build
with ThreadPoolExecutor(3) as pool:
    list(pool.map(build.build, ('fused_attention_fwd', 'fused_attention_bwd', 'probes')))"
for stage in $stages; do
  case $stage in
    small|scaled|leftovers|xmodal|rsa|traces) $stage ;;
    *) echo "unknown stage $stage"; exit 2 ;;
  esac
done
exit $failed
