from sdrmodem.server.tcp_server import main

main()
