"""Host-side utilities of the port: the debug-bitmask decoder, the CLIs'
argument table, recursive tensor-to-host mappers and the scalar running
mean (``utils.misc``), and the headless ``--debug_MVSnet`` stage dumps
(``utils.debug_dump``)."""

from .misc import DictAverageMeter, get_powers, make_recursive_func, print_args, to_float, to_numpy

__all__ = [
    "DictAverageMeter",
    "get_powers",
    "make_recursive_func",
    "print_args",
    "to_float",
    "to_numpy",
]
