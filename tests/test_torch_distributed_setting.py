"""``SET enable_distributed_execution = 1`` on one device.

The reference asks ``get_default_mesh()`` for a mesh, gets None under two
devices, and every distributed operator hands its input to the host
operator. The port, on one device with no mesh installed, must answer the
same way: each statement returns, with the setting on, exactly what it
returns with it off, and what the other package returns. (The JAX package runs here on 8 forced
host devices, so its side does take the exchanges: equal rows also hold the
port's host answer to the reference's distributed one. The aggregates are
integer sums, counts and maxima, exact in the exchanges' f32.)
"""

import pytest

from databend_tpu.service.session import SessionContext as JaxContext
from databend_tpu.utils import tracing as jtracing

from databend_tpu_torch import backend
from databend_tpu_torch.parallel import exchange, fragmenter, mesh
from databend_tpu_torch.service.session import SessionContext as TorchContext
from databend_tpu_torch.utils import tracing as ttracing

STATEMENTS = {
    "group_by": "SELECT a, sum(b), count(*), max(b) FROM t GROUP BY a "
                "ORDER BY a",
    "order_by": "SELECT a, b FROM t ORDER BY b, a",
    "order_by_limit": "SELECT a, b FROM t ORDER BY b DESC, a LIMIT 7",
    "join": "SELECT t.a, b, c FROM t JOIN u ON t.a = u.a ORDER BY b, c",
    "window": "SELECT a, b, row_number() OVER (PARTITION BY a ORDER BY b, s) "
              "FROM t ORDER BY a, b, s",
    "agg_topn": "SELECT a, sum(b) AS sb FROM t GROUP BY a "
                "HAVING sum(b) > 100 ORDER BY sb DESC LIMIT 3",
}


@pytest.fixture(scope="module", autouse=True)
def _torch_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(backend.DEVICE_ENV, "cpu")
        yield


@pytest.fixture(scope="module", autouse=True)
def _drain_span_rings():
    """Statements on either SessionContext record spans in their package's
    process-wide ring; empty both after the module, so that a later test
    file on this worker (tests/test_explain_profile.py) reads only its own
    spans."""
    yield
    jtracing.RECORDER.drain()
    ttracing.RECORDER.drain()


def _load(ctx):
    ctx.sql("CREATE TABLE t (a INT, b INT, s VARCHAR)")
    rows = ", ".join(f"({i % 11}, {(i * 37) % 101}, 's{i % 5}')"
                     for i in range(400))
    ctx.sql(f"INSERT INTO t VALUES {rows}")
    ctx.sql("CREATE TABLE u (a INT, c INT)")
    ctx.sql("INSERT INTO u VALUES "
            + ", ".join(f"({i}, {i * 100})" for i in range(0, 14, 2)))


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    j = JaxContext(str(tmp_path_factory.mktemp("jax")))
    t = TorchContext(str(tmp_path_factory.mktemp("torch")))
    _load(j)
    _load(t)
    yield j, t
    j.close()
    t.close()


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_answers_with_the_setting_on(ctxs, name):
    j, t = ctxs
    sql = STATEMENTS[name]
    off = t.sql(sql).rows()
    assert off and j.sql(sql).rows() == off
    for ctx in (j, t):
        ctx.sql("SET enable_distributed_execution = 1")
    try:
        assert t.sql(sql).rows() == off
        assert j.sql(sql).rows() == off
    finally:
        for ctx in (j, t):
            ctx.sql("SET enable_distributed_execution = 0")


def test_the_port_hands_out_no_mesh():
    assert mesh.get_default_mesh() is None
    m = mesh.make_mesh()
    assert m.axis_names == (mesh.DP_AXIS, mesh.SHARD_AXIS)
    assert m.shape == {"dp": 1, "shard": 1}
    with pytest.raises(ValueError):
        mesh.make_mesh(n_devices=3, dp=2, devices=[backend.device()] * 3)


@pytest.mark.parametrize("name", [
    "range_partition_sort", "sharded_topn", "sharded_grouped_agg",
    "sharded_shuffle_grouped_agg", "broadcast_lookup_join", "ShuffleJoin",
    "shuffle_by_key"])
def test_exchange_names_decline_when_called(name):
    """Without a mesh an exchange has nothing to run on: called with
    something else it raises, as the reference's does, and never answers
    on its own."""
    from databend_tpu.parallel import exchange as jexchange
    for mod in (jexchange, exchange):
        with pytest.raises((AttributeError, TypeError)):
            getattr(mod, name)(object())


def test_fragment_matches_and_declines_without_a_mesh(ctxs):
    """The host half matches the fused fragment as the reference does;
    executing it without a mesh answers None (the host path takes over)."""
    from databend_tpu.parallel import fragmenter as jfrag
    j, t = ctxs
    found = {}
    for ctx, mod in ((j, jfrag), (t, fragmenter)):
        real = mod.match_agg_topn

        def spy(plan, real=real, mod=mod):
            frag = real(plan)
            found[mod] = frag
            return frag

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "match_agg_topn", spy)
            ctx.sql("SET enable_distributed_execution = 1")
            try:
                ctx.sql(STATEMENTS["agg_topn"]).rows()
            finally:
                ctx.sql("SET enable_distributed_execution = 0")
    jf, tf = found[jfrag], found[fragmenter]
    assert tf is not None and tf.execute() is None
    assert (tf.ops, tf.spec, tf.key, tf.hcode) == \
        (jf.ops, jf.spec, jf.key, jf.hcode)
