"""Mutable segmented corpus: add/delete/compact with exact parity against
a fresh single-segment scan of the alive rows."""

import numpy as np
import pytest

import innr_tpu as it


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _oracle(qs, rows, ids, k, mode):
    """Exact top-k over (rows, permanent ids) with lower-id tie-break."""
    qs = np.atleast_2d(qs).astype(np.float64)
    out_s, out_i = [], []
    for q in qs:
        if mode == "dot":
            s = rows.astype(np.float64) @ q
            order = np.lexsort((ids, -s))
        elif mode == "l2":
            d = rows.astype(np.float64) - q[None, :]
            s = np.sum(d * d, axis=1)
            order = np.lexsort((ids, s))
        else:
            qs_n = q / max(np.linalg.norm(q), 1e-30)
            rn = np.linalg.norm(rows.astype(np.float64), axis=1)
            s = (rows.astype(np.float64) @ qs_n) / np.where(rn > 0, rn, 1.0)
            s = np.where(rn > 1e-9, s, 0.0)
            order = np.lexsort((ids, -s))
        out_s.append(s[order[:k]])
        out_i.append(ids[order[:k]])
    return np.stack(out_s), np.stack(out_i)


class TestSegmentedCorpus:
    def test_add_search_across_segments(self, rng):
        d = 32
        sc = it.SegmentedCorpus(d)
        r1 = rng.standard_normal((300, d)).astype(np.float32)
        r2 = rng.standard_normal((200, d)).astype(np.float32)
        a, b = sc.add(r1)
        assert (a, b) == (0, 300)
        c, e = sc.add(r2)
        assert (c, e) == (300, 500)
        assert sc.num_segments == 2 and sc.num_vectors == 500
        qs = rng.standard_normal((4, d)).astype(np.float32)
        scores, ids = sc.knn_dot(qs, 7)
        all_rows = np.concatenate([r1, r2])
        want_s, want_i = _oracle(qs, all_rows, np.arange(500), 7, "dot")
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_allclose(scores, want_s, rtol=1e-5)

    @pytest.mark.parametrize("mode", ["dot", "l2", "cosine"])
    def test_delete_excluded_exactly(self, rng, mode):
        d = 16
        # auto_compact off: this test asserts raw tombstone state (120
        # dead > the default 25% compaction trigger).
        sc = it.SegmentedCorpus(d, auto_compact=False)
        rows = rng.standard_normal((400, d)).astype(np.float32)
        sc.add(rows[:250])
        sc.add(rows[250:])
        dead = rng.choice(400, 120, replace=False)
        assert sc.delete(dead) == 120
        assert sc.delete(dead) == 0  # idempotent
        assert sc.num_vectors == 280 and sc.num_deleted == 120
        alive_mask = np.ones(400, bool)
        alive_mask[dead] = False
        qs = rng.standard_normal((3, d)).astype(np.float32)
        fn = {"dot": sc.knn_dot, "l2": sc.knn, "cosine": sc.knn_cosine}[mode]
        scores, ids = fn(qs, 9)
        want_s, want_i = _oracle(
            qs, rows[alive_mask], np.arange(400)[alive_mask], 9, mode
        )
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_allclose(scores, want_s, rtol=1e-4, atol=1e-5)
        assert not set(np.ravel(ids)) & set(dead.tolist())

    def test_compact_preserves_ids_and_results(self, rng):
        d = 16
        sc = it.SegmentedCorpus(d)
        rows = rng.standard_normal((300, d)).astype(np.float32)
        sc.add(rows[:100]); sc.add(rows[100:180]); sc.add(rows[180:])
        sc.delete(np.arange(0, 300, 3))
        q = rng.standard_normal(d).astype(np.float32)
        before_s, before_i = sc.knn_dot(q, 8)
        sc.compact()
        assert sc.num_segments == 1 and sc.num_deleted == 0
        after_s, after_i = sc.knn_dot(q, 8)
        np.testing.assert_array_equal(before_i, after_i)
        np.testing.assert_allclose(before_s, after_s, rtol=1e-6)
        # ids remain permanent: adding after compaction continues the counter
        a, b = sc.add(rows[:5])
        assert a == 300 and b == 305

    def test_single_query_and_edges(self, rng):
        d = 8
        sc = it.SegmentedCorpus(d)
        s, i = sc.knn_dot(np.zeros(d, np.float32), 5)
        assert len(i) == 0  # empty corpus
        rows = rng.standard_normal((20, d)).astype(np.float32)
        sc.add(rows)
        s, i = sc.knn_dot(rows[4], 1)
        assert int(i[0]) == 4
        sc.delete([4])
        s, i = sc.knn_dot(rows[4], 1)
        assert int(i[0]) != 4
        s, i = sc.knn_dot(rows[0], 100)  # k clamps to alive count
        assert len(i) == 19
        with pytest.raises(it.ContractError):
            sc.add(rng.standard_normal((3, d + 1)).astype(np.float32))
        with pytest.raises(it.ContractError):
            it.SegmentedCorpus(0)
        # delete everything -> empty results
        sc.delete(np.arange(20))
        s, i = sc.knn_dot(rows[0], 3)
        assert len(i) == 0

    def test_fused_path_above_threshold(self, rng, monkeypatch, force_triton):
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn as kknn

        force_triton()
        d = 16
        sc = it.SegmentedCorpus(d)
        rows = rng.standard_normal((200, d)).astype(np.float32)
        sc.add(rows)
        calls = []
        real = kknn.knn_keys

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(kknn, "knn_keys", spy)
        scores, ids = sc.knn_dot(rows[:2], 3)
        assert calls, "segment scan should ride the fused kernel"
        want_s, want_i = _oracle(rows[:2], rows, np.arange(200), 3, "dot")
        np.testing.assert_array_equal(np.asarray(ids), want_i)

    def test_dead_pin_loses_to_alive_nan(self, rng):
        """Review regression: tombstone placeholders must lose to every
        alive candidate under total order — including NaN-scored rows,
        which +-inf score-space pins would wrongly outrank."""
        sc = it.SegmentedCorpus(4)
        sc.add(np.array(
            [[1, 0, 0, 0], [0, 1, 0, 0], [np.nan, 0, 0, 0]], np.float32
        ))
        sc.delete([0])
        s, i = sc.knn(np.zeros(4, np.float32), 2)  # L2 ascending
        assert set(np.asarray(i).tolist()) == {1, 2}, np.asarray(i)
        assert 0 not in np.asarray(i)
        assert not np.any(np.asarray(i) >= 3)  # no fabricated ids
        # NaN sorts last ascending: alive row 1 first, NaN row 2 second
        assert int(np.asarray(i)[0]) == 1 and np.isnan(np.asarray(s)[1])

    def test_persistence_roundtrip(self, rng, tmp_path):
        from innr_tpu.io import load_npz, save_npz

        d = 8
        sc = it.SegmentedCorpus(d)
        rows = rng.standard_normal((60, d)).astype(np.float32)
        sc.add(rows[:40]); sc.add(rows[40:])
        sc.delete([3, 17, 55])
        p = str(tmp_path / "seg.npz")
        save_npz(p, sc)
        loaded = load_npz(p)
        q = rng.standard_normal(d).astype(np.float32)
        s1, i1 = sc.knn_dot(q, 6)
        s2, i2 = loaded.knn_dot(q, 6)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6)
        # id counter persists: new rows never reuse deleted/old ids
        a, b = loaded.add(rows[:2])
        assert a == 60

    def test_auto_compaction_on_dead_fraction(self, rng):
        d = 8
        sc = it.SegmentedCorpus(d)  # defaults: max_dead_frac 0.25
        rows = rng.standard_normal((200, d)).astype(np.float32)
        sc.add(rows)
        sc.delete(np.arange(60))  # 30% dead -> compaction fires
        assert sc.num_deleted == 0
        assert sc.num_segments == 1
        assert sc.num_vectors == 140
        q = rng.standard_normal(d).astype(np.float32)
        _, ids = sc.knn_dot(q, 5)
        assert all(int(g) >= 60 for g in ids)

    def test_auto_compaction_on_segment_count(self, rng):
        d = 8
        sc = it.SegmentedCorpus(d, max_segments=4)
        for _ in range(6):
            sc.add(rng.standard_normal((10, d)).astype(np.float32))
        assert sc.num_segments <= 4 + 1
        assert sc.num_vectors == 60

    def test_delete_heavy_workload_stays_fused_and_exact(self, rng, monkeypatch, force_triton):
        """VERDICT r2 item 7 done-criterion: a delete-heavy workload
        (50% tombstones attempted, many segments) never leaves the fused
        path and always matches brute force."""
        from innr_tpu import config
        from innr_tpu.kernels import triton_knn as kknn

        force_triton()
        d = 16
        sc = it.SegmentedCorpus(d, max_segments=5)
        all_rows, killed = {}, set()
        for b in range(20):  # 20 segments added; auto-compaction tiers them
            block = rng.standard_normal((40, d)).astype(np.float32)
            a, e = sc.add(block)
            for j, g in enumerate(range(a, e)):
                all_rows[g] = block[j]
            kill = rng.choice(list(set(all_rows) - killed),
                              size=min(20, len(all_rows) - len(killed)),
                              replace=False)
            sc.delete(kill)
            killed |= {int(x) for x in kill}
        assert sc.num_segments <= 6
        # every remaining segment rides the fused kernel
        unfused = []
        real = kknn.knn_keys

        def spy(*a, **kw):
            unfused.append(0)
            return real(*a, **kw)

        monkeypatch.setattr(kknn, "knn_keys", spy)
        qs = rng.standard_normal((3, d)).astype(np.float32)
        scores, ids = sc.knn_dot(qs, 7)
        assert len(unfused) == sc.num_segments
        gids = np.array(sorted(set(all_rows) - killed), np.int64)
        mat = np.stack([all_rows[g] for g in gids])
        s = qs.astype(np.float64) @ mat.T
        for i in range(3):
            order = np.lexsort((gids, -s[i].astype(np.float32)))[:7]
            np.testing.assert_array_equal(np.asarray(ids)[i], gids[order])

    def test_random_mutation_sequence_matches_oracle(self, rng):
        """Property-style: a random add/delete interleaving must always
        match a brute-force scan of the alive (id, row) set."""
        d = 6
        sc = it.SegmentedCorpus(d)
        alive: dict[int, np.ndarray] = {}
        for step in range(12):
            op = rng.random()
            if op < 0.5 or not alive:
                n = int(rng.integers(1, 30))
                block = rng.standard_normal((n, d)).astype(np.float32)
                a, b = sc.add(block)
                for j, gid in enumerate(range(a, b)):
                    alive[gid] = block[j]
            elif op < 0.8:
                kill = rng.choice(list(alive), size=min(5, len(alive)), replace=False)
                sc.delete(kill)
                for gid in kill:
                    alive.pop(int(gid))
            else:
                sc.compact()
            if alive and step % 3 == 2:
                q = rng.standard_normal(d).astype(np.float32)
                k = min(4, len(alive))
                scores, ids = sc.knn_dot(q, k)
                gids = np.array(sorted(alive), np.int64)
                mat = np.stack([alive[g] for g in gids])
                s = mat.astype(np.float64) @ q
                order = np.lexsort((gids, -s))[:k]
                assert list(np.asarray(ids)) == list(gids[order]), step
        assert sc.num_vectors == len(alive)
