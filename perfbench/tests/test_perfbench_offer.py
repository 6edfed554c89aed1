"""The open-loop generator of the serving cells: every request goes at its
time whatever the server does, and under ``max_outstanding`` one that
comes while that many are unanswered is shed, not sent."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from perfbench.drivers import poisson_serve


class HeldServer:
    """A server that answers only when told."""

    def __init__(self):
        self.futures = []

    def submit(self, clip):
        f = Future()
        self.futures.append(f)
        return f


def drive(n, slots, release_after=None):
    server = HeldServer()
    now = time.perf_counter()
    sched = [now + 0.01 * i for i in range(n)]
    sent, done, futures, shed = [None] * n, [None] * n, [None] * n, [False] * n
    clips = np.zeros((1, 2), np.uint8)
    if release_after is not None:
        def release():
            time.sleep(release_after)
            server.futures[0].set_result(("g", None))
        threading.Thread(target=release).start()
    poisson_serve.offer(server, clips, [0] * n, sched, sent, done, futures,
                        threading.Event(), slots, shed)
    return server, sent, done, shed


def test_without_a_cap_every_request_is_sent():
    server, sent, _, shed = drive(6, None)
    assert len(server.futures) == 6 and all(s is not None for s in sent) and not any(shed)


def test_a_full_server_sheds_requests_until_an_answer_frees_a_slot():
    server, sent, done, shed = drive(8, threading.Semaphore(2), release_after=0.035)
    assert shed[2] and shed[3]
    assert sent[0] is not None and sent[1] is not None and done[0] is not None
    # The answer to the first frees one slot: one later request goes, no more.
    assert sum(s is not None for s in sent) == 3
    assert sum(shed) == 5 and all(shed[i] == (sent[i] is None) for i in range(8))
