#!/usr/bin/env bash
# Launcher of the PyTorch/CUDA port (distributed_training_pytorch_tpu_torch): torchrun with
# one process per card, the counterpart of run.sh (which stays the JAX launcher).
#
# On one host:      ./run_torch.sh
# On several hosts, once per host:
#   NNODES=<hosts> NODE_RANK=<i> MASTER_ADDR=<host0-ip> MASTER_PORT=1234 ./run_torch.sh
#
# NPROC is the processes per host (default: the cards nvidia-smi lists). Each process is
# one data-parallel rank; the entries read the same env knobs as the JAX entries (BATCH,
# EPOCHS, DTYPE, PALLAS, MESH, ...; see each entry's docstring).
set -euo pipefail
cd "$(dirname "$0")"

# NCCL settings of the PyTorch reference's launcher; each one can be overridden from the
# environment. NCCL_SOCKET_IFNAME (the reference's eno1) names a host's interface, so it
# is left to the operator: set it where the default interface is the wrong one.
export NCCL_DEBUG="${NCCL_DEBUG:-INFO}"
export NCCL_IB_DISABLE="${NCCL_IB_DISABLE:-1}"
export NCCL_ALGO="${NCCL_ALGO:-Ring}"
export NCCL_PROTO="${NCCL_PROTO:-Simple}"
export NCCL_P2P_LEVEL="${NCCL_P2P_LEVEL:-NVL}"
export TORCH_NCCL_TRACE_BUFFER_SIZE="${TORCH_NCCL_TRACE_BUFFER_SIZE:-104857600}"

# MODEL selects the entry:
#   (unset) / vgg16  -> VGG16 / CIFAR-10 (examples/train_cifar10.py). Its default BASE_LR
#                       of 0.1 (lr 0.4 at batch 1024) takes VGG16, which has no BatchNorm,
#                       to a non-finite loss within 2 epochs, as it does the JAX entry;
#                       BASE_LR=0.005 trains.
#   resnet50         -> ResNet-50 / ImageNet recipe (examples/train_imagenet.py)
#   vit_b16          -> ViT-B/16 / ImageNet recipe (AdamW; flash attention kernels unless PALLAS=0)
#   convnext_l       -> ConvNeXt-L / ImageNet-21k recipe (AdamW, ACCUM=4; PALLAS=1 fuses the
#                       expand Dense + GELU into the 1x1 kernel)
#   convnext_tiny    -> the convnext_l recipe on a small ConvNeXt
#   lm               -> the causal-LM entry (examples/train_lm.py; LM_SIZE=tiny|small)
#   digits           -> VGG16 to accuracy on the digits corpus (examples/train_digits.py;
#                       the corpus ships with the port, no sklearn needed)
#   records          -> ResNet18Slim to accuracy on the digits corpus packed into record
#                       shards (examples/train_records.py)
MODEL="${MODEL:-vgg16}"
case "$MODEL" in
  vgg16) ENTRY=train_cifar10 ;;
  resnet50|vit_b16|convnext_l|convnext_tiny) ENTRY=train_imagenet ;;
  lm) ENTRY=train_lm ;;
  digits) ENTRY=train_digits ;;
  records) ENTRY=train_records ;;
  *)
    echo "run_torch.sh: unknown MODEL=$MODEL (vgg16, resnet50, vit_b16, convnext_l, convnext_tiny, lm, digits or records)" >&2
    exit 2 ;;
esac

NPROC="${NPROC:-$( (nvidia-smi -L 2>/dev/null || true) | grep -c '^GPU' || true)}"
if [ "${NPROC:-0}" -lt 1 ]; then
  echo "run_torch.sh: no card visible (nvidia-smi -L lists none); set NPROC, or run an entry with DEVICE=cpu" >&2
  exit 2
fi
exec python3 -m torch.distributed.run \
  --nproc_per_node="$NPROC" \
  --nnodes="${NNODES:-1}" \
  --node_rank="${NODE_RANK:-0}" \
  --master_addr="${MASTER_ADDR:-localhost}" \
  --master_port="${MASTER_PORT:-1234}" \
  -m "distributed_training_pytorch_tpu_torch.examples.$ENTRY" "$@"
