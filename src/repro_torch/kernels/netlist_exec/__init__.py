from .ops import execute_packed, netlist_exec
from .ref import execute_packed_ref, netlist_exec_ref

__all__ = ["execute_packed", "execute_packed_ref", "netlist_exec",
           "netlist_exec_ref"]
