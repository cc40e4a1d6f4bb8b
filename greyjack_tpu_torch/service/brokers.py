"""Message-broker transports for the solving service (counterpart of
`greyjack_tpu/service/brokers.py`; host-side Python, no device code).

The reference's vrp_service consumes tasks from RabbitMQ and streams every
new global-best solution to an exchange
(`examples/vrp_service/src/main.rs:30-105`,
`observers/rabbitmq_observer.rs:31-57`). This environment has no broker, so
the transport is pluggable:

  * InProcessBroker — queue.Queue pair, for tests and embedding;
  * HttpBroker     — stdlib http.server: POST /tasks enqueues a task JSON,
                     GET /solutions streams results (long-poll);
  * RabbitMqBroker — thin pika adapter, import-gated on `pika`.

`HttpBroker(port=0)` takes an ephemeral port (read it from `.port`).
"""

from __future__ import annotations

import json
import queue
import threading


class InProcessBroker:
    def __init__(self):
        self.tasks = queue.Queue()
        self.solutions = queue.Queue()

    def submit_task(self, task_json):
        self.tasks.put(task_json)

    def next_task(self, timeout=None):
        try:
            return self.tasks.get(timeout=timeout)
        except queue.Empty:
            return None

    def publish_solution(self, solution_json):
        self.solutions.put(solution_json)

    def next_solution(self, timeout=None):
        try:
            return self.solutions.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        pass


class HttpBroker(InProcessBroker):
    """HTTP facade over the in-process queues (stdlib only)."""

    def __init__(self, host="127.0.0.1", port=8077):
        super().__init__()
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        broker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if self.path == "/tasks":
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    broker.submit_task(json.loads(body))
                    self.send_response(202)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_GET(self):
                if self.path == "/solutions":
                    solution = broker.next_solution(timeout=30)
                    payload = json.dumps(solution).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_response(404)
                    self.end_headers()

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join()


class RabbitMqBroker:
    """pika adapter matching the reference queue/exchange names
    (`vrp_task_data` / `vrp_solutions_exchange`)."""

    def __init__(self, host, port=5672, task_queue="vrp_task_data",
                 solutions_exchange="vrp_solutions_exchange",
                 routing_key="vrp_out"):
        try:
            import pika
        except ImportError as e:
            raise ImportError(
                "RabbitMqBroker requires `pika`, which is not installed; "
                "use InProcessBroker or HttpBroker instead"
            ) from e
        self._pika = pika
        self.connection = pika.BlockingConnection(
            pika.ConnectionParameters(host=host, port=port))
        self.channel = self.connection.channel()
        self.task_queue = task_queue
        self.solutions_exchange = solutions_exchange
        self.routing_key = routing_key

    def submit_task(self, task_json):
        """Client-side publish to the task queue (default exchange), the
        reference python client's role
        (`python_client/scripts/solve_vrp_by_rust_service.py:1-70`)."""
        self.channel.basic_publish(exchange="", routing_key=self.task_queue,
                                   body=json.dumps(task_json))

    def next_task(self, timeout=None):
        method, _props, body = self.channel.basic_get(self.task_queue,
                                                      auto_ack=True)
        return json.loads(body) if body else None

    def publish_solution(self, solution_json):
        self.channel.basic_publish(
            exchange=self.solutions_exchange,
            routing_key=self.routing_key,
            body=json.dumps(solution_json),
        )

    def close(self):
        self.connection.close()
