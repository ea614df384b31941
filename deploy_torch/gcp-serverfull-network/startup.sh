#!/bin/bash
set -e
python -m pip install pygrid-tpu
export DATABASE_URL=grid.db
exec python -m pygrid_tpu_torch.network --host 0.0.0.0 --port 7000
