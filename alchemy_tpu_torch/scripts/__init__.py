"""The port's measuring tools — counterparts of the JAX package's `scripts/`,
each run as `python -m alchemy_tpu_torch.scripts.<name>` (on the card;
`--device cpu` for the plain versions on the CPU). Each prints its record on
stdout as JSON with the JAX script's keys plus `backend` and `card`
(`alchemy_tpu_torch.bench`); those that write a file write it under
build/bench/ or to `--out`.

- `verify_device`: every CUDA kernel of the harness against its plain
  version (`bench`'s `native_kernel_checks`);
- `bench_hybrid`, `bench_batch`: TrivGad against hybrid at L = 16; sustained
  throughput at B = 256 and 1024;
- `bench_examples`, `bench_erw`, `profile_examples`: the shipped examples as
  CUDA graphs (`jit_compile`): call time, the noise probe's error rates,
  the device-time breakdown;
- `profile_trace`: device time by kernel, busy time and idle share over a
  steady window (`torch.profiler`);
- `bench_pipeline`, `bench_strategy`, `bench_comm_fit`: the pipelined chain,
  a2a against the ring for the dist NTT, and an affine fit of
  `all_to_all_single`, across rank processes (`parallel.multihost.LocalWorld`);
- `microbench_mxu`: int8 tensor-core matmuls against bf16 at the digit-NTT
  shapes (library calls: evidence for a kernel design).

`scripts/profile_mul_relin.py`'s counterpart is
`alchemy_tpu_torch/examples/profile_mul_relin.py`.
"""
