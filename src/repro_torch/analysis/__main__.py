"""Command: ``python -m repro_torch.analysis --all [--protocol NAME]
[--device cpu|cuda] [--json PATH]``.

Runs the three passes over every registered protocol (or a named
subset) on the card, or on the CPU with ``--device cpu``; prints the
count of findings of each rule and every failure, optionally writes the
machine-readable per-subject, per-rule report, and exits non-zero on any
violated contract.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import api

from . import run_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m repro_torch.analysis',
        description='Contract checker of the port: launch, schedule and '
                    'convention passes over the protocol registry.')
    parser.add_argument('--all', action='store_true',
                        help='check every registered protocol (default '
                             'when no --protocol is given)')
    parser.add_argument('--protocol', action='append', default=None,
                        metavar='NAME',
                        help='check only this protocol (repeatable)')
    parser.add_argument('--device', default='cuda', choices=('cpu', 'cuda'),
                        help='where the cells run (default: the card)')
    parser.add_argument('--json', default=None, metavar='PATH',
                        help='write the machine-readable report here')
    parser.add_argument('-v', '--verbose', action='store_true',
                        help='print every finding, not just failures')
    args = parser.parse_args(argv)

    names = None if args.all or not args.protocol else set(args.protocol)
    if names is not None:
        known = {p.name for p in api.PROTOCOLS.values()}
        bad = names - known
        if bad:
            parser.error(f'unknown protocol(s) {sorted(bad)} '
                         f'(registered: {sorted(known)})')

    report = run_all(names, device=args.device)
    shown = report.findings if args.verbose else report.failures
    for f in shown:
        print(f)
    for rule in sorted(report.rules()):
        ok, na, failed = report.counts(rule)
        print(f'{rule}: {ok} ok, {na} not applicable, {failed} failed')
    if args.json:
        report.to_json(args.json)
        print(f'wrote {args.json}')
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == '__main__':
    sys.exit(main())
