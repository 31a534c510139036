"""The benchmark of tpu_engine_torch (the PyTorch and CUDA port).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json: it writes a random
Q4_K_M GGUF of the cell's configuration from the seed, serves it through
tpu_engine_torch.api.server (/loadmodel, then /v1/chat/completions),
drives the cell's traffic from a load generator in a process of its own,
measures for the given seconds, checks the served tokens against a plain
PyTorch reference, and prints one JSON line.

Everything here reads only what the cell names: configs/<config>.json
(with the model module of models/ that the file names: the reference,
and the GGUF's tensors and metadata; weights.py, gguf_file.py),
traffic/<traffic>.json, and metrics/<metric>.py (or metrics/<prefix>.py,
where <prefix> is the part of the name before its first dot). Nothing
here imports jax or the JAX package, and models/ imports nothing of the
program.
"""
