"""The benchmark of the PyTorch/CUDA port of MVSNet
(``scene_3dreconstruction_mvsnet_tpu_torch``): ``python3 mvsbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``, one cell once,
on the NVIDIA card of the machine it runs on. ``BENCHMARK.json`` at the
checkout's root is its manifest."""
