#!/bin/bash
set -e
python -m pip install pygrid-tpu
export DATABASE_URL=grid.db
export MASTER_ADDR=pygrid-node-alice-0
export MASTER_PORT=29500
export WORLD_SIZE=2
export NODE_RANK="$(curl -sf -H 'Metadata-Flavor: Google' http://metadata.google.internal/computeMetadata/v1/instance/attributes/node-rank)"
export RANK="$NODE_RANK"
exec python -m pygrid_tpu_torch.node --id alice --host 0.0.0.0 --port 5000 --device cuda --network http://network.example.com:7000
