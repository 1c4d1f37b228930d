"""Command-line tools over the port: ``chaos_campaign`` (a chaos plan as
a gate; runs as a script, under ``python -S`` for the stdlib ``lite``
plan) and ``serve_fleet`` (a subprocess fleet under closed-loop load,
with the autopilot, a rollout and a replica kill)."""
