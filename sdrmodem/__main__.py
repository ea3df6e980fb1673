"""CLI entry: ``python -m sdrmodem <config>`` — the reference's
``sdr_modem <config>`` analog (src/main.c:15-44)."""
from sdrmodem.server.tcp_server import main

main()
