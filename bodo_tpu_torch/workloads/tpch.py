"""TPC-H workload: schema-faithful data generator + the 22 queries.

The port's copy of bodo_tpu/workloads/tpch.py: the same generator (the
same frames from the same seed), the same 22 query texts and the same
sqlite oracle. `gen_tpch(n_orders=1_500_000)` is scale factor 1: 1.5M
orders, about 6.0M lineitem rows, 150k customers, 300k parts, about
1.2M partsupp rows and 15k suppliers.

Run through the port's SQL entry point:

    from bodo_tpu_torch.sql import BodoSQLContext
    ctx = BodoSQLContext(gen_tpch(n_orders=900, seed=3), device="cpu")
    ctx.sql(QUERIES[1]).to_pandas()
"""

from __future__ import annotations

import re as _re

import numpy as np

NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                  "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]


def gen_tpch(n_orders: int = 1500, seed: int = 0):
    """Generate a consistent TPC-H dataset (~n_orders orders; lineitem is
    ~4x that). Row counts scale like the spec's relative sizes."""
    import pandas as pd

    r = np.random.default_rng(seed)
    n_cust = max(10, n_orders // 10)
    n_part = max(20, n_orders // 5)
    n_supp = max(5, n_orders // 100)

    region = pd.DataFrame({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS,
        "r_comment": [f"region {i}" for i in range(5)],
    })
    nation = pd.DataFrame({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int64),
        "n_name": NATIONS,
        "n_regionkey": np.asarray(NATION_REGION, dtype=np.int64),
        "n_comment": [f"nation {i}" for i in range(len(NATIONS))],
    })
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(n_supp)],
        "s_address": [f"addr{i}" for i in range(n_supp)],
        "s_nationkey": r.integers(0, len(NATIONS), n_supp),
        "s_phone": [f"{r.integers(10, 35)}-{i:07d}" for i in range(n_supp)],
        "s_acctbal": np.round(r.uniform(-999, 9999, n_supp), 2),
        "s_comment": r.choice(["reliable", "slow Customer Complaints",
                               "quick", "steady"], n_supp),
    })
    part = pd.DataFrame({
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_name": [f"{r.choice(['green','blue','red','ivory','misty'])} "
                   f"{r.choice(['almond','tomato','salmon','olive'])} part{i}"
                   for i in range(n_part)],
        "p_mfgr": [f"Manufacturer#{r.integers(1, 6)}" for _ in range(n_part)],
        "p_brand": [f"Brand#{r.integers(1, 6)}{r.integers(1, 6)}"
                    for _ in range(n_part)],
        "p_type": r.choice(TYPES, n_part),
        "p_size": r.integers(1, 51, n_part),
        "p_container": r.choice(CONTAINERS, n_part),
        "p_retailprice": np.round(r.uniform(900, 2000, n_part), 2),
        "p_comment": [f"part comment {i}" for i in range(n_part)],
    })
    n_ps = n_part * 4
    partsupp = pd.DataFrame({
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int64), 4),
        "ps_suppkey": r.integers(0, n_supp, n_ps),
        "ps_availqty": r.integers(1, 10000, n_ps),
        "ps_supplycost": np.round(r.uniform(1, 1000, n_ps), 2),
        "ps_comment": [f"ps comment {i}" for i in range(n_ps)],
    }).drop_duplicates(["ps_partkey", "ps_suppkey"]).reset_index(drop=True)
    customer = pd.DataFrame({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(n_cust)],
        "c_address": [f"caddr{i}" for i in range(n_cust)],
        "c_nationkey": r.integers(0, len(NATIONS), n_cust),
        "c_phone": [f"{r.integers(10, 35)}-{i:07d}" for i in range(n_cust)],
        "c_acctbal": np.round(r.uniform(-999, 9999, n_cust), 2),
        "c_mktsegment": r.choice(SEGMENTS, n_cust),
        "c_comment": [f"customer comment {i}" for i in range(n_cust)],
    })
    odate = (np.datetime64("1992-01-01") +
             r.integers(0, 2405, n_orders).astype("timedelta64[D]"))
    orders = pd.DataFrame({
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_custkey": r.integers(0, n_cust, n_orders),
        "o_orderstatus": r.choice(["O", "F", "P"], n_orders),
        "o_totalprice": np.round(r.uniform(850, 500000, n_orders), 2),
        "o_orderdate": pd.Series(odate.astype("datetime64[ns]")),
        "o_orderpriority": r.choice(PRIORITIES, n_orders),
        "o_clerk": [f"Clerk#{r.integers(1, 1000):09d}"
                    for _ in range(n_orders)],
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
        "o_comment": r.choice(["fast", "slow special requests deposit",
                               "normal", "special packages requests"],
                              n_orders),
    })
    nl = r.integers(1, 8, n_orders)
    okeys = np.repeat(orders.o_orderkey.to_numpy(), nl)
    n_li = len(okeys)
    ship_delay = r.integers(1, 122, n_li).astype("timedelta64[D]")
    o_dates = np.repeat(odate, nl)
    sdate = o_dates + ship_delay
    cdate = sdate + r.integers(1, 31, n_li).astype("timedelta64[D]")
    rdate = sdate + r.integers(1, 31, n_li).astype("timedelta64[D]")
    lineitem = pd.DataFrame({
        "l_orderkey": okeys,
        "l_partkey": r.integers(0, n_part, n_li),
        "l_suppkey": r.integers(0, n_supp, n_li),
        "l_linenumber": np.concatenate(
            [np.arange(1, k + 1) for k in nl]).astype(np.int64),
        "l_quantity": r.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(r.uniform(900, 100000, n_li), 2),
        "l_discount": np.round(r.uniform(0, 0.10, n_li), 2),
        "l_tax": np.round(r.uniform(0, 0.08, n_li), 2),
        "l_returnflag": r.choice(["R", "A", "N"], n_li),
        "l_linestatus": r.choice(["O", "F"], n_li),
        "l_shipdate": pd.Series(sdate.astype("datetime64[ns]")),
        "l_commitdate": pd.Series(cdate.astype("datetime64[ns]")),
        "l_receiptdate": pd.Series(rdate.astype("datetime64[ns]")),
        "l_shipinstruct": r.choice(["DELIVER IN PERSON", "COLLECT COD",
                                    "NONE", "TAKE BACK RETURN"], n_li),
        "l_shipmode": r.choice(SHIPMODES, n_li),
        "l_comment": [f"li {i}" for i in range(n_li)],
    })
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


# Queries the port cannot run yet, with the route that stops each (it
# raises NotImplementedError naming that route): none. Q16's COUNT(DISTINCT)
# runs through the sort groupby's nunique; Q21's non-equality correlated
# EXISTS through the row-id decorrelation (the rowid window op).
UNSUPPORTED: dict = {}

# The 22 standard TPC-H queries (spec text, standard parameters).
QUERIES = {
1: """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey
  and p_size = 15 and p_type like '%BRASS'
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
      select min(ps_supplycost)
      from partsupp, supplier, nation, region
      where p_partkey = ps_partkey and s_suppkey = ps_suppkey
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
3: """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
""",
4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
""",
5: """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc
""",
6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07 and l_quantity < 24
""",
7: """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
             extract(year from l_shipdate) as l_year,
             l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey
        and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
             or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate between date '1995-01-01' and date '1996-12-31'
     ) shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
""",
8: """
select o_year,
       sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
         as mkt_share
from (select extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount) as volume,
             n2.n_name as nation
      from part, supplier, lineitem, orders, customer,
           nation n1, nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
        and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
        and o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL'
     ) all_nations
group by o_year
order by o_year
""",
9: """
select nation, o_year, sum(amount) as sum_profit
from (select n_name as nation, extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount)
               - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey and p_partkey = l_partkey
        and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%'
     ) profit
group by nation, o_year
order by nation, o_year desc
""",
10: """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20
""",
11: """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
      and n_name = 'GERMANY')
order by value desc
""",
12: """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH' then 1 else 0 end)
         as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH' then 1 else 0 end)
         as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
""",
13: """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders
           on c_custkey = o_custkey
           and o_comment not like '%special%requests%'
      group by c_custkey
     ) c_orders
group by c_count
order by custdist desc, c_count desc
""",
14: """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
""",
15: """
with revenue0 as (
    select l_suppkey as supplier_no,
           sum(l_extendedprice * (1 - l_discount)) as total_revenue
    from lineitem
    where l_shipdate >= date '1996-01-01'
      and l_shipdate < date '1996-01-01' + interval '3' month
    group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
""",
16: """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (select s_suppkey from supplier
                         where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)
""",
18: """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) as total_qty
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having sum(l_quantity) > 150)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
""",
19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
       and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l_quantity >= 1 and l_quantity <= 11
       and p_size between 1 and 5
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = 'Brand#23'
       and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l_quantity >= 10 and l_quantity <= 20
       and p_size between 1 and 10
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = 'Brand#34'
       and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l_quantity >= 20 and l_quantity <= 30
       and p_size between 1 and 15
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
""",
20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'green%')
      and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem
                         where l_partkey = ps_partkey
                           and l_suppkey = ps_suppkey
                           and l_shipdate >= date '1994-01-01'
                           and l_shipdate < date '1994-01-01'
                                             + interval '1' year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
""",
21: """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
""",
22: """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone from 1 for 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone from 1 for 2) in
            ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (select avg(c_acctbal) from customer
                         where c_acctbal > 0.00
                           and substring(c_phone from 1 for 2) in
                               ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select * from orders
                        where o_custkey = c_custkey)
     ) custsale
group by cntrycode
order by cntrycode
""",
}


# ---------------------------------------------------------------------------
# sqlite oracle helpers: translate the standard query texts into
# sqlite's dialect so the stdlib engine can serve as a differential
# baseline.
# ---------------------------------------------------------------------------

def fold_intervals(sql: str) -> str:
    """date 'X' ± interval 'N' unit → folded literal (sqlite has neither)."""
    pat = _re.compile(
        r"date\s+'([0-9-]+)'\s*([+-])\s*interval\s+'(\d+)'\s+(\w+)")

    def repl(m):
        d = np.datetime64(m.group(1))
        n = int(m.group(3))
        sign = 1 if m.group(2) == "+" else -1
        unit = m.group(4).lower().rstrip("s")
        if unit in ("year", "month"):
            months = n * (12 if unit == "year" else 1) * sign
            out = (d.astype("datetime64[M]") + months).astype("datetime64[D]")
        else:
            days = {"day": 1}[unit] * n * sign
            out = d + np.timedelta64(days, "D")
        return f"date '{out}'"

    prev = None
    while prev != sql:
        prev = sql
        sql = pat.sub(repl, sql)
    return sql


def to_sqlite(sql: str) -> str:
    sql = fold_intervals(sql)
    sql = _re.sub(r"date\s+'([0-9-]+)'", r"'\1'", sql)
    sql = _re.sub(r"extract\s*\(\s*year\s+from\s+([A-Za-z_0-9.]+)\s*\)",
                  r"CAST(strftime('%Y', \1) AS INTEGER)", sql)
    sql = _re.sub(r"substring\s*\(\s*([A-Za-z_0-9.]+)\s+from\s+(\d+)\s+"
                  r"for\s+(\d+)\s*\)", r"substr(\1, \2, \3)", sql)
    return sql


# the join keys the oracle indexes, one index a tuple (an index changes
# no result; at scale factor 1 the correlated subqueries of Q2, Q17,
# Q20, Q21 and Q22 would otherwise rescan a table once an outer row, and
# Q9 and Q20 look lineitem up by (partkey, suppkey))
JOIN_KEYS = {
    "lineitem": (("l_orderkey",), ("l_partkey", "l_suppkey"),
                 ("l_suppkey",)),
    "orders": (("o_orderkey",), ("o_custkey",)),
    "partsupp": (("ps_partkey", "ps_suppkey"), ("ps_suppkey",)),
    "part": (("p_partkey",),),
    "customer": (("c_custkey",),),
    "supplier": (("s_suppkey",),),
}


def _create_indexes(conn, name: str) -> None:
    for cols in JOIN_KEYS.get(name, ()):
        conn.execute(f"create index ix_{'_'.join(cols)} on {name} "
                     f"({', '.join(cols)})")


def sqlite_connection(data):
    """Load a gen_tpch() dict into an in-memory sqlite DB (dates as
    'YYYY-MM-DD' text)."""
    import sqlite3
    conn = sqlite3.connect(":memory:")
    for name, df in data.items():
        df2 = df.copy()
        for c in df2.columns:
            if df2[c].dtype.kind == "M":
                df2[c] = df2[c].dt.strftime("%Y-%m-%d")
        df2.to_sql(name, conn, index=False)
    return conn


def normalize(df, has_order: bool):
    """A result frame in comparable form: dates as 'YYYY-MM-DD', floats
    as float64, strings as str, all-null object columns as float NaN
    (sqlite returns all-NULL aggregates as None), and rows sorted by
    every column unless the query orders them. The sort reads the floats
    rounded to 4 places (then unrounded), so rows whose floats differ in
    their last bits between two engines sort alike; the floats
    themselves are not rounded."""
    out = df.reset_index(drop=True)
    floats = []
    for c in out.columns:
        if out[c].dtype.kind == "M":
            out[c] = out[c].dt.strftime("%Y-%m-%d")
        elif out[c].dtype.kind == "f":
            out[c] = out[c].astype(float)
            floats.append(c)
        elif out[c].dtype == object:
            if out[c].isna().all():
                out[c] = out[c].astype("float64")
                floats.append(c)
            else:
                out[c] = out[c].astype(str)
    if not has_order and len(out.columns):
        keys = out.copy()
        keys.columns = [f"k{i}" for i in range(len(out.columns))]
        for i, c in enumerate(out.columns):
            if c in floats:
                keys[f"k{i}"] = np.round(out[c], 4)
                keys[f"f{i}"] = out[c]
        order = keys.sort_values(list(keys.columns), kind="stable").index
        out = out.iloc[order.to_numpy()]
    return out.reset_index(drop=True)


def check_against_sqlite(got, exp, sql: str, rtol: float,
                         label: str = "") -> None:
    """Raise AssertionError unless `got` equals sqlite's `exp` for the
    query `sql` after `normalize`: row counts, integers, strings, dates
    and the row order of an ORDER BY exactly, floats unrounded within
    `rtol` (and no absolute tolerance)."""
    got = got.copy()
    if len(got.columns) != len(exp.columns):
        raise AssertionError(f"{label}: columns {list(got.columns)} vs "
                             f"{list(exp.columns)}")
    got.columns = list(exp.columns)
    has_order = "order by" in sql.lower()
    g = normalize(got, has_order)
    e = normalize(exp, has_order)
    if len(g) != len(e):
        raise AssertionError(f"{label}: {len(g)} vs {len(e)} rows")
    for c in e.columns:
        if e[c].dtype.kind == "f" or g[c].dtype.kind == "f":
            np.testing.assert_allclose(
                g[c].astype(float), e[c].astype(float), rtol=rtol, atol=0,
                equal_nan=True, err_msg=f"{label} col {c}")
        elif list(g[c].astype(str)) != list(e[c].astype(str)):
            raise AssertionError(f"{label} col {c}")


# the window queries' processes in the oracle (one a query at a time)
WINDOW_PROCS = 4


def windows_oracle_path(out_path: str) -> str:
    """Where the oracle that writes the TPC-H results to `out_path`
    writes the window queries' results: beside them."""
    import os
    return os.path.join(os.path.dirname(out_path), "windows_oracle.pkl")


def sqlite_results(n_orders: int, seed: int, db_path: str, out_path: str,
                   workers: int = 6) -> None:
    """The sqlite oracle at `gen_tpch(n_orders, seed)`: the frames are
    loaded into a database file at `db_path` with an index on each join
    key; the 22 queries run on `workers` threads, each with its own
    connection (sqlite releases the GIL while a statement runs), and
    workloads/windows.WINDOW_SQL, whose queries return millions of rows,
    beside them in WINDOW_PROCS processes (`_query_to_file`: a row
    fetched takes the GIL, so threads fetching millions each would
    queue on it). As soon as the 22 are done, {"results": {q:
    DataFrame}, "gen_s", "load_s", "query_s": {q: seconds}, "wall_s"}
    is pickled to `out_path`; when the window queries are done too, the
    same keys over them to `windows_oracle_path(out_path)`."""
    import multiprocessing
    import pickle
    import sqlite3
    import time
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import pandas as pd

    from bodo_tpu_torch.workloads.windows import WINDOW_SQL
    t0 = time.perf_counter()
    data = gen_tpch(n_orders=n_orders, seed=seed)
    gen_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    conn = sqlite3.connect(db_path)
    # a scratch file: no journal, no syncs, a 2 GB page cache
    conn.execute("pragma journal_mode = off")
    conn.execute("pragma synchronous = off")
    conn.execute("pragma cache_size = -2000000")
    for name, df in data.items():
        df2 = df.copy()
        for c in df2.columns:
            if df2[c].dtype.kind == "M":
                df2[c] = df2[c].dt.strftime("%Y-%m-%d")
        df2.to_sql(name, conn, index=False, chunksize=1 << 16)
        _create_indexes(conn, name)
    conn.execute("analyze")  # row counts for sqlite's join planner
    conn.commit()
    conn.close()
    del data
    load_s = time.perf_counter() - t1

    def run(q):
        c = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
        # the file mapped once for every reader, a 1 GB cache each
        c.execute("pragma mmap_size = 17179869184")
        c.execute("pragma cache_size = -1000000")
        try:
            s = time.perf_counter()
            df = pd.read_sql_query(to_sqlite(QUERIES[q]), c)
            return q, df, time.perf_counter() - s
        finally:
            c.close()

    # the slowest queries first, so the pool drains evenly
    order = sorted(QUERIES, key=lambda q: (q not in (9, 20, 7, 18, 21), q))
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=WINDOW_PROCS,
                             mp_context=spawn) as procs, \
            ThreadPoolExecutor(max_workers=workers) as pool:
        windows = {name: procs.submit(_query_to_file, db_path, sql,
                                      f"{db_path}.{name}.pkl")
                   for name, sql in WINDOW_SQL.items()}
        done = list(pool.map(run, order))
        _dump({"results": {q: df for q, df, _ in done}, "gen_s": gen_s,
               "load_s": load_s, "query_s": {q: s for q, _, s in done},
               "wall_s": time.perf_counter() - t0}, out_path)
        query_s = {name: f.result() for name, f in windows.items()}
    results = {}
    for name in WINDOW_SQL:
        with open(f"{db_path}.{name}.pkl", "rb") as f:
            results[name] = pickle.load(f)
    _dump({"results": results, "gen_s": gen_s, "load_s": load_s,
           "query_s": query_s, "wall_s": time.perf_counter() - t0},
          windows_oracle_path(out_path))


def _query_to_file(db_path: str, sql: str, out_path: str) -> float:
    """Run one query on a read-only connection of its own (in a worker
    process) and pickle its DataFrame to `out_path`; temporary tables
    (a window's partition buffers) stay in memory. Returns the seconds
    the query took."""
    import pickle
    import sqlite3
    import time

    import pandas as pd
    c = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    c.execute("pragma mmap_size = 17179869184")
    c.execute("pragma cache_size = -1000000")
    c.execute("pragma temp_store = memory")
    try:
        s = time.perf_counter()
        df = pd.read_sql_query(sql, c)
        took = time.perf_counter() - s
    finally:
        c.close()
    with open(out_path, "wb") as f:
        pickle.dump(df, f)
    return took


def _dump(obj, path: str) -> None:
    """Pickle `obj` to `path` through a temporary name, so a reader that
    sees the file sees all of it."""
    import os
    import pickle
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _oracle_main(argv=None) -> int:
    """python -m bodo_tpu_torch.workloads.tpch --n-orders N --seed S
    --db PATH --out PICKLE: sqlite_results, the TPC-H queries' results
    to PICKLE and the window queries' beside it."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--n-orders", type=int, default=1_500_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--db", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--workers", type=int, default=6)
    a = p.parse_args(argv)
    sqlite_results(a.n_orders, a.seed, a.db, a.out, a.workers)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_oracle_main())
