"""Plain versions: the level-by-level executor of core/scheduler.py, of the
kernel's own signature, and the levelized netlist executor built on it
(itself bit-exact against the gate-serial core/netlist.execute)."""
from ...core.scheduler import execute_levelized as execute_packed_ref
from ...core.scheduler import run_levels as netlist_exec_ref

__all__ = ["execute_packed_ref", "netlist_exec_ref"]
