"""Test doubles for the server integration tests.

- ``MockSdrServer``  — in-process TCP server speaking the sdr-server
  protocol (analog of reference test/sdr_server_mock.c): accepts the
  handshake and pushes IQ on demand.
- ``ModemClient``    — a real wire-protocol client (analog of
  test/sdr_modem_client.c).
"""

from __future__ import annotations

import asyncio
import struct

import numpy as np

from sdrmodem.server import wire

_SS_HEADER = struct.Struct(">BB")
_SS_REQUEST = struct.Struct(">IIIB")
_SS_RESPONSE = struct.Struct(">BI")


class MockSdrServer:
    def __init__(self):
        self.server: asyncio.Server | None = None
        self.requests: list[tuple] = []
        self.clients: list[asyncio.StreamWriter] = []
        self._client_connected = asyncio.Event()

    async def start(self) -> int:
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        return self.server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        hdr = await reader.readexactly(_SS_HEADER.size)
        version, msg_type = _SS_HEADER.unpack(hdr)
        assert version == 0 and msg_type == 0
        body = await reader.readexactly(_SS_REQUEST.size)
        self.requests.append(_SS_REQUEST.unpack(body))
        writer.write(_SS_HEADER.pack(0, 2) + _SS_RESPONSE.pack(0, 0))
        await writer.drain()
        self.clients.append(writer)
        self._client_connected.set()
        # keep connection open; close when the modem sends SHUTDOWN
        try:
            while True:
                data = await reader.read(4096)
                if not data or (len(data) >= 2 and data[1] == 1):
                    break
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def wait_client(self):
        await self._client_connected.wait()

    async def send_iq(self, iq: np.ndarray):
        data = np.asarray(iq, np.complex64).tobytes()
        for w in self.clients:
            w.write(data)
            await w.drain()

    async def close_clients(self):
        for w in self.clients:
            w.close()

    async def stop(self):
        await self.close_clients()
        if self.server:
            self.server.close()
            await self.server.wait_closed()


class ModemClient:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(cls, host: str, port: int) -> "ModemClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def _send(self, msg_type: wire.MsgType, payload: bytes = b""):
        self.writer.write(wire.frame(msg_type, payload))
        await self.writer.drain()

    async def read_response(self) -> wire.Response:
        hdr = await self.reader.readexactly(wire.HEADER.size)
        version, msg_type, length = wire.parse_header(hdr)
        assert msg_type == wire.MsgType.RESPONSE, f"unexpected type {msg_type}"
        payload = await self.reader.readexactly(length)
        return wire.Response.decode(payload)

    async def ping(self) -> wire.Response:
        await self._send(wire.MsgType.PING)
        return await self.read_response()

    async def rx_request(self, req: wire.RxRequest) -> wire.Response:
        await self._send(wire.MsgType.RX_REQUEST, req.encode())
        return await self.read_response()

    async def tx_request(self, req: wire.TxRequest) -> wire.Response:
        await self._send(wire.MsgType.TX_REQUEST, req.encode())
        return await self.read_response()

    async def tx_data(self, data: bytes) -> wire.Response:
        await self._send(wire.MsgType.TX_DATA, wire.TxData(data=data).encode())
        return await self.read_response()

    async def read_stream(self, n: int, timeout: float = 10.0) -> bytes:
        return await asyncio.wait_for(self.reader.readexactly(n), timeout)

    async def shutdown(self):
        await self._send(wire.MsgType.SHUTDOWN)

    def close(self):
        self.writer.close()
