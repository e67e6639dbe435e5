from .ops import crossbar_nor, execute_netlist
from .ref import crossbar_nor_ref, execute_netlist_ref

__all__ = ["crossbar_nor", "crossbar_nor_ref", "execute_netlist",
           "execute_netlist_ref"]
