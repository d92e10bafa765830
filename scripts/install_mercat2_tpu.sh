#!/usr/bin/env bash
# Environment bootstrap — the equivalent of the reference's
# install_mercat2.sh: no ray/fastqc/fastp/prodigal binaries (built-in
# replacements cover them; pyrodigal is optional and enables the real
# Prodigal gene model for -prod). Works with conda or a plain venv.
set -euo pipefail

ENV_NAME="${ENV_NAME:-mercat2-tpu}"
PYTHON="${PYTHON:-python3}"

if command -v conda >/dev/null 2>&1; then
  eval "$(conda shell.bash hook)"
  conda create -n "$ENV_NAME" -c conda-forge -y \
    "python>=3.10" pip numpy scipy scikit-learn matplotlib-base
  conda activate "$ENV_NAME"
else
  "$PYTHON" -m venv "$HOME/.venvs/$ENV_NAME"
  # shellcheck disable=SC1090
  source "$HOME/.venvs/$ENV_NAME/bin/activate"
  pip install numpy scipy scikit-learn matplotlib
fi

# NVIDIA GPU hosts: JAX with its CUDA 12 plugin; elsewhere the CPU wheel
# works for development
if command -v nvidia-smi >/dev/null 2>&1; then
  pip install "jax[cuda12]"
else
  pip install jax
fi

# optional: real Prodigal gene model for -prod
pip install pyrodigal || echo "pyrodigal unavailable; -prod uses the built-in ORF finder"

pip install "$(dirname "$0")/.."

# build the native IO library (zlib-streaming FASTA/FASTQ parser + packers)
make -C "$(dirname "$0")/../native" || echo "native build skipped; numpy parser fallback active"

mercat2-tpu --version
