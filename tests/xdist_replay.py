"""Replay pytest-xdist's `--dist load` scheduler over the case times of a
junit file, to predict how a collection order spreads a run over six workers
(`-n 6`).

    python tests/xdist_replay.py JUNIT.xml ORDER.txt

ORDER.txt holds the node ids in collection order, one a line, as
`python -m pytest tests/ -m 'not slow' -p no:randomly --collect-only` prints
them (the root conftest.py's reorder included). The replay follows
xdist 3.8's `LoadScheduling`: each worker first takes
`len(order) // workers // 4` consecutive cases, then, when it holds fewer
than `pending // workers // 4` and either its last case took under 0.1 s or
it holds fewer than two, it is topped up to `pending // workers // 2`; a
worker starts a case only once it holds the next one too, or has been told
that no more will come. It prints each worker's seconds and the slowest,
which is the run's wall time less start-up. A case the junit file does not
time counts as 0 s.
"""

import argparse
import heapq
import xml.etree.ElementTree as ET


def junit_seconds(path):
    """{node id: seconds} of a junit file of module-level test functions."""
    return {
        case.get("classname").replace(".", "/") + ".py::" + case.get("name"):
            float(case.get("time"))
        for case in ET.parse(path).getroot().iter("testcase")
    }


def replay(order, seconds, workers=6):
    """Each worker's list of the node ids it runs under `--dist load`."""
    pending = list(order)
    queues = [[] for _ in range(workers)]
    clock = [0.0] * workers
    shut = [False] * workers
    ran = [[] for _ in range(workers)]
    running = []  # heap of (finish, worker, seconds)

    def send(w, num):
        queues[w].extend(pending[:num])
        del pending[:num]

    def start(w):
        if queues[w] and (len(queues[w]) >= 2 or shut[w]):
            took = seconds.get(queues[w][0], 0.0)
            ran[w].append(queues[w][0])
            heapq.heappush(running, (clock[w] + took, w, took))

    for w in range(workers):
        send(w, max(2, len(order) // workers // 4))
    for w in range(workers):
        shut[w] = not pending
        start(w)
    while running:
        finish, w, took = heapq.heappop(running)
        clock[w] = finish
        queues[w].pop(0)
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            held = len(queues[w])
            if held < low and not (took >= 0.1 and held >= 2):
                send(w, high - held)
        else:
            shut[w] = True
        start(w)
    return ran


def main():
    ap = argparse.ArgumentParser(
        description="Replay xdist's --dist load over a junit file's times.")
    ap.add_argument("junit")
    ap.add_argument("order")
    args = ap.parse_args()
    seconds = junit_seconds(args.junit)
    with open(args.order) as f:
        order = [line.strip() for line in f if "::" in line]
    ran = replay(order, seconds)
    loads = [sum(seconds.get(nodeid, 0.0) for nodeid in r) for r in ran]
    for w, load in enumerate(loads):
        print(f"gw{w}: {len(ran[w])} cases, {load:.1f} s")
    untimed = sum(nodeid not in seconds for nodeid in order)
    print(f"wall {max(loads):.1f} s of {sum(loads):.1f} worker-seconds "
          f"(even split {sum(loads) / len(loads):.1f} s); "
          f"{len(order)} cases, {untimed} untimed")


if __name__ == "__main__":
    main()
