# Verification gate (SURVEY.md §4): one command a round can run.
#
#   make check       - tests + entry/dryrun (CPU, 8 virtual devices)
#   make test        - full pytest suite (forced-CPU, 8 virtual devices)
#   make entry       - entry() compile check + dryrun_multichip on CPU
#   make native      - build the C++ host toolkit
#
# On a machine with a GPU: `python chip_smoke.py` (one card) and
# `python chip_smoke.py --four-cards` (four cards).

PY ?= python

.PHONY: check test entry native

check: test entry

test:
	$(PY) -m pytest tests/ -q

entry:
	$(PY) __graft_entry__.py

native:
	$(MAKE) -C native
