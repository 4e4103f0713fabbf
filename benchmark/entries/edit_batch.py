"""Entry: one batched edit, `parallel.batch.edit_batch` with the
request's transforms (the mix's "batch" of them) on the set-up's photo,
set up, counted and checked as `transform_foreground`'s: a request
completes one edit per transform."""

from benchmark import harness

_edit = harness.load_entry("transform_foreground")
units, flops, readings = _edit.units, _edit.flops, _edit.readings


def setup(session) -> dict:
    return _edit.setup(session, serve_with=_batch)


def serve(session, state: dict, request: dict):
    return _batch(session.handles, session.mix, state, request)


def _batch(handles, mix: dict, state: dict, request: dict):
    from diffusionhandles_tpu_torch.parallel.batch import edit_batch
    photo = state["photo"]
    return edit_batch(handles, photo["depth"], mix["prompt"],
                      photo["fg_mask"], photo["bg_depth"], state["null"],
                      state["noise"], state["acts"], request["transforms"],
                      return_disparities=True)
