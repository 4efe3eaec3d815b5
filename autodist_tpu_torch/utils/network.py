"""Network/address utilities.

The port's copy of ``autodist_tpu/utils/network.py`` (stdlib only; the
port imports nothing of the JAX package): whether a resource-spec node
address names this machine. One difference: the JAX module also learns
the outbound interface's address by connecting a UDP socket toward a
public address; the port leaves that probe out, so it opens no socket
toward any outside address, and matches this host's names and the
addresses they resolve to.
"""
import socket
from typing import Set


def _local_addresses() -> Set[str]:
    addrs = {"127.0.0.1", "localhost", "::1"}
    hostname = socket.gethostname()
    addrs.add(hostname)
    try:
        addrs.update(info[4][0] for info in socket.getaddrinfo(hostname, None))
    except socket.gaierror:
        pass
    return addrs


def _host_of(address: str) -> str:
    """Strip device/port suffixes: 'h:GPU:0' -> 'h', '[::1]:80' -> '::1',
    bare IPv6 like '::1' passes through unchanged."""
    if address.startswith("["):  # bracketed IPv6
        return address[1:].split("]")[0]
    try:
        import ipaddress
        ipaddress.IPv6Address(address)
        return address
    except (ValueError, ImportError):
        pass
    return address.split(":")[0]


def is_loopback_address(address: str) -> bool:
    return _host_of(address) in ("127.0.0.1", "localhost", "::1")


def is_local_address(address: str) -> bool:
    return _host_of(address) in _local_addresses()
