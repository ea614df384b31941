#!/bin/bash
set -e
python3 -m pip install pygrid-tpu
export DATABASE_URL=grid.db
exec python3 -m pygrid_tpu_torch.node --id alice --host 0.0.0.0 --port 5000 --device cpu --network http://network.example.com:7000
