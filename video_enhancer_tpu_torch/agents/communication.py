"""Agent communication: an asyncio message broker and a heartbeat registry.

Counterpart (a copy) of video_enhancer_tpu/agents/communication.py:
``MessageBroker`` with per-agent asyncio queues and delivery confirmation,
``AgentRegistry`` with heartbeat monitoring (30 s beat, 90 s timeout), and
the ``AgentCommunicationSystem`` facade whose ``send_task_to_agent`` runs
an agent's task in the event loop's executor. Host-side control plane; no
device work.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import uuid
from typing import Any, Callable

__all__ = ["AgentMessage", "MessageBroker", "AgentRegistry",
           "AgentCommunicationSystem"]

HEARTBEAT_INTERVAL = 30.0
HEARTBEAT_TIMEOUT = 90.0


@dataclasses.dataclass
class AgentMessage:
    sender: str
    recipient: str
    message_type: str
    payload: Any = None
    message_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12])
    timestamp: float = dataclasses.field(default_factory=time.time)


class MessageBroker:
    def __init__(self):
        self._queues: dict[str, asyncio.Queue] = {}
        self._confirmations: dict[str, asyncio.Future] = {}
        self.stats = {"sent": 0, "delivered": 0, "broadcast": 0}

    def register(self, agent_id: str) -> None:
        self._queues.setdefault(agent_id, asyncio.Queue())

    def unregister(self, agent_id: str) -> None:
        self._queues.pop(agent_id, None)

    async def send(self, msg: AgentMessage, confirm: bool = False,
                   timeout: float = 10.0) -> bool:
        q = self._queues.get(msg.recipient)
        if q is None:
            return False
        fut = None
        if confirm:
            fut = asyncio.get_event_loop().create_future()
            self._confirmations[msg.message_id] = fut
        await q.put(msg)
        self.stats["sent"] += 1
        if fut is not None:
            try:
                await asyncio.wait_for(fut, timeout)
                return True
            except asyncio.TimeoutError:
                return False
            finally:
                self._confirmations.pop(msg.message_id, None)
        return True

    async def broadcast(self, msg: AgentMessage) -> int:
        n = 0
        for agent_id, q in self._queues.items():
            if agent_id != msg.sender:
                await q.put(dataclasses.replace(msg, recipient=agent_id))
                n += 1
        self.stats["broadcast"] += 1
        return n

    async def receive(self, agent_id: str,
                      timeout: float | None = None) -> AgentMessage | None:
        q = self._queues.get(agent_id)
        if q is None:
            return None
        try:
            msg = await (asyncio.wait_for(q.get(), timeout) if timeout
                         else q.get())
        except asyncio.TimeoutError:
            return None
        self.stats["delivered"] += 1
        fut = self._confirmations.get(msg.message_id)
        if fut is not None and not fut.done():
            fut.set_result(True)
        return msg


class AgentRegistry:
    def __init__(self):
        self._agents: dict[str, dict] = {}
        self._callbacks: list[Callable[[str, str], None]] = []

    def register(self, agent_id: str, agent: Any = None,
                 meta: dict | None = None) -> None:
        self._agents[agent_id] = {
            "agent": agent,
            "meta": meta or {},
            "last_heartbeat": time.time(),
            "status": "available",
        }

    def heartbeat(self, agent_id: str) -> None:
        if agent_id in self._agents:
            self._agents[agent_id]["last_heartbeat"] = time.time()
            if self._agents[agent_id]["status"] == "unavailable":
                self._set_status(agent_id, "available")

    def check_timeouts(self) -> list[str]:
        """Mark agents unavailable after HEARTBEAT_TIMEOUT (reference
        agent_communication_system.py:466-490 monitor loop)."""
        now = time.time()
        expired = []
        for agent_id, rec in self._agents.items():
            if rec["status"] == "available" and \
                    now - rec["last_heartbeat"] > HEARTBEAT_TIMEOUT:
                self._set_status(agent_id, "unavailable")
                expired.append(agent_id)
        return expired

    def _set_status(self, agent_id: str, status: str) -> None:
        self._agents[agent_id]["status"] = status
        for cb in self._callbacks:
            cb(agent_id, status)

    def on_status_change(self, cb: Callable[[str, str], None]) -> None:
        self._callbacks.append(cb)

    def get(self, agent_id: str):
        rec = self._agents.get(agent_id)
        return rec["agent"] if rec else None

    def available_agents(self) -> list[str]:
        return [a for a, rec in self._agents.items()
                if rec["status"] == "available"]

    def get_status(self) -> dict:
        return {
            a: {"status": rec["status"],
                "last_heartbeat_age_sec": time.time() - rec["last_heartbeat"]}
            for a, rec in self._agents.items()
        }


class AgentCommunicationSystem:
    """Facade (reference agent_communication_system.py:519-677)."""

    def __init__(self):
        self.broker = MessageBroker()
        self.registry = AgentRegistry()

    def register_agent(self, agent_id: str, agent: Any = None,
                       meta: dict | None = None) -> None:
        self.broker.register(agent_id)
        self.registry.register(agent_id, agent, meta)

    async def send_task_to_agent(self, sender: str, agent_id: str,
                                 task, timeout: float = 300.0) -> dict:
        """Deliver a task to an agent and run it (in-process direct call,
        which is also what the reference's practical path does,
        process_endpoints.py:909-918)."""
        agent = self.registry.get(agent_id)
        if agent is None or \
                self.registry._agents[agent_id]["status"] != "available":
            return {"status": "failed", "error": f"agent {agent_id} unavailable"}
        msg = AgentMessage(sender=sender, recipient=agent_id,
                           message_type="task", payload=task)
        await self.broker.send(msg)
        loop = asyncio.get_event_loop()
        result = await asyncio.wait_for(
            loop.run_in_executor(None, agent.process_task, task), timeout
        )
        self.registry.heartbeat(agent_id)
        return result.to_dict()

    def get_system_status(self) -> dict:
        return {
            "broker_stats": dict(self.broker.stats),
            "agents": self.registry.get_status(),
        }
