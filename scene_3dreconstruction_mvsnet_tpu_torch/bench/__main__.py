"""``python -m scene_3dreconstruction_mvsnet_tpu_torch.bench``: the headline
bench (``bench/headline.py``, the counterpart of ``bench.py``)."""

from .headline import main

if __name__ == "__main__":
    main()
