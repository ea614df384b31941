#!/bin/bash
set -e
python -m pip install pygrid-tpu
export DATABASE_URL=grid.db
exec python -m pygrid_tpu_torch.node --id alice --host 0.0.0.0 --port 5000 --device cuda --network http://network.example.com:7000
