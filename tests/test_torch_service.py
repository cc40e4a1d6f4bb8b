"""The port's solving service on the CPU: twin of `tests/test_service.py`
(JSON round trip, observer streaming, fake `pika`, the HTTP broker), plus
`domain_to_task_json` against the JAX package's on the same instance.
Tolerance: none, every comparison is exact."""

import json
import sys
import types
import urllib.request

import numpy as np
import torch

from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.service.solver_service import (
    domain_to_task_json as j_task_json)
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.service import (HttpBroker, InProcessBroker,
                                        SolverService)
from greyjack_tpu_torch.service.solver_service import (JsonDomainBuilder,
                                                       domain_to_task_json)
from greyjack_tpu_torch.solver import SolverLoggingLevels
from greyjack_tpu_torch.utils.math_utils import round_decimal_t

torch.set_num_threads(1)


def _agent():
    return TabuSearch(16, 0.2, True, None, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
                      5, StepsLimit(15))


def test_json_domain_roundtrip():
    domain = generate_instance(15, 2, 4, seed=3, time_windowed=True,
                               device="cpu")
    task = domain_to_task_json(domain)
    # the JAX package's JSON for the same instance, key for key
    jtask = j_task_json(j_generate(15, 2, 4, seed=3, time_windowed=True))
    assert json.dumps(task) == json.dumps(jtask)
    rebuilt = JsonDomainBuilder(task, device="cpu").build_domain_from_scratch()
    assert len(rebuilt.customers_vec) == len(domain.customers_vec)
    assert len(rebuilt.vehicles) == len(domain.vehicles)
    assert rebuilt.time_windowed
    assert rebuilt.vehicles[0].capacity == domain.vehicles[0].capacity
    assert rebuilt.distance_matrix.device.type == "cpu"
    np.testing.assert_array_equal(rebuilt.distance_matrix.numpy(),
                                  domain.distance_matrix.numpy())


def test_service_streams_solutions():
    broker = InProcessBroker()
    domain = generate_instance(12, 1, 3, seed=8, device="cpu")
    broker.submit_task(domain_to_task_json(domain))
    service = SolverService(broker, _agent, n_jobs=2,
                            logging_level=SolverLoggingLevels.Silent, seed=5,
                            device="cpu")
    final = service.serve_one(timeout=1)
    assert final is not None
    streamed = []
    while True:
        s = broker.next_solution(timeout=0.1)
        if s is None:
            break
        streamed.append(s)
    assert streamed[-1] == "Solving finished"
    assert len(streamed) >= 2  # at least one improvement + the marker
    assert "sum_travel_distance" in streamed[0]
    # the last streamed solution is the returned one, and its score is a
    # plain rescore of it, rounded to the service's precision (0, 0, 3)
    assert streamed[-2]["solution"] == final
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(
        JsonDomainBuilder(domain_to_task_json(domain), device="cpu")
        .build_domain_from_scratch(), False))
    row = round_decimal_t(req.request_score_plain(torch.tensor(
        [[v for _, v in final[0]]], dtype=torch.float64)), [0, 0, 3])
    assert [final[1]["hard_score"], final[1]["medium_score"],
            final[1]["soft_score"]] == row[0].tolist()
    assert service.serve_one(timeout=0.05) is None


def test_rabbitmq_broker_fake_pika(monkeypatch):
    """The RabbitMqBroker adapter against an in-memory fake `pika`: task
    submit / consume and solution publish follow the reference's
    queue / exchange contract (`vrp_service/src/main.rs:30-105`)."""
    queues = {}
    published = []

    class FakeChannel:
        def basic_publish(self, exchange, routing_key, body):
            if exchange == "":
                queues.setdefault(routing_key, []).append(body)
            else:
                published.append((exchange, routing_key, body))

        def basic_get(self, queue, auto_ack=False):
            pending = queues.get(queue, [])
            if pending:
                return ("method", None, pending.pop(0))
            return (None, None, None)

    class FakeConnection:
        def __init__(self, params):
            self.params = params
            self.closed = False

        def channel(self):
            return FakeChannel()

        def close(self):
            self.closed = True

    fake_pika = types.ModuleType("pika")
    fake_pika.BlockingConnection = FakeConnection
    fake_pika.ConnectionParameters = (
        lambda host, port: {"host": host, "port": port})
    monkeypatch.setitem(sys.modules, "pika", fake_pika)

    from greyjack_tpu_torch.service.brokers import RabbitMqBroker

    broker = RabbitMqBroker("localhost")
    assert broker.next_task() is None

    broker.submit_task({"job": 1, "payload": [1, 2, 3]})
    assert broker.next_task() == {"job": 1, "payload": [1, 2, 3]}
    assert broker.next_task() is None

    broker.publish_solution({"score": [0, 1.5]})
    assert published == [
        ("vrp_solutions_exchange", "vrp_out", json.dumps({"score": [0, 1.5]}))
    ]
    broker.close()
    assert broker.connection.closed


def test_rabbitmq_broker_needs_pika(monkeypatch):
    import pytest

    monkeypatch.setitem(sys.modules, "pika", None)
    from greyjack_tpu_torch.service.brokers import RabbitMqBroker

    with pytest.raises(ImportError, match="requires `pika`"):
        RabbitMqBroker("localhost")


def test_http_broker():
    broker = HttpBroker(port=0)
    try:
        assert broker.port != 0
        domain = generate_instance(10, 1, 3, seed=2, device="cpu")
        task = domain_to_task_json(domain)
        req = urllib.request.Request(
            f"http://127.0.0.1:{broker.port}/tasks",
            data=json.dumps(task).encode(), method="POST")
        assert urllib.request.urlopen(req, timeout=5).status == 202
        got = broker.next_task(timeout=2)
        assert got["metadata"]["vehicles_count"] == 3
        assert got == json.loads(json.dumps(task))

        broker.publish_solution({"hello": "world"})
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{broker.port}/solutions", timeout=5)
        assert json.loads(resp.read()) == {"hello": "world"}
    finally:
        broker.close()
    assert not broker._thread.is_alive()
