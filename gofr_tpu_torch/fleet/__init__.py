"""The fleet's wire helpers the KV handoff needs (the port's own copy of a
part of gofr_tpu/fleet/, in ``channel``). The fleet itself (supervisor,
lockstep channel, autoscaler, router) is not ported yet (ROADMAP.md
Queue A 9)."""
